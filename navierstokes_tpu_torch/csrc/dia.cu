// Scalar-DIA SpMV (kernel K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels navierstokes_tpu/ops/pallas_dia.py::_dia_kernel
// (x resident in VMEM) and ::_dia_kernel_windowed (x windows DMA'd from HBM),
// both driven there by spmv_dia_pallas.  It computes
//
//     y[i] = sum_k  data[k, i] * x[i + offsets[k]]
//
// over the K diagonals, in the order given.  Layout: data (K, n) row-major
// and contiguous, x and y (n,).  One kernel covers both TPU variants: which
// of them ran was a question of VMEM residency, which has no counterpart
// here.
//
// What bounds it: bytes.  Each operator value is read once and used for one
// multiply-add: 2 flops per 4 bytes in f32 (per 8 bytes in f64), far below
// the card's ridge point.  The design streams the operator at full
// bandwidth: one thread per row i, blocks of 256 threads, and a loop over
// the diagonals unrolled by 8 so that eight independent loads of data and x
// are in flight per thread.  data[k, i] is read coalesced along i.  x is read
// once per diagonal, but neighbouring diagonals touch the same lines, which
// stay in L1/L2.  At matrix 6 (n = 117,500) the grid has 460 blocks on the
// 132 SMs, enough warps to hide latency (unlike K1's one thread per node).
// A variant that streamed the operator through a shared-memory ring of bulk
// copies (the design of K1's tiled route, band_ring.cuh) was built and timed
// on an H100 against this kernel: level from ~470k rows up, slower below and
// whenever the operator is warm in the L2 (PERF.md), so it was not kept.
//
// The offsets travel by value in the kernel's parameter block (constant
// bank), so every thread of a warp reads the same offset as a broadcast.
// K is at most kMaxDiagonals (81 for the operator A, 123 for S = D^{-1} A
// and at most 81 for the multilevel coarse level on the channel family).
//
// Edges: x[i + off] is read only where 0 <= i + off < n and counts as zero
// elsewhere.  The TPU kernel got these zeros from a zero-padded copy of x;
// DIA storage does not promise zeros in data where i + off leaves the
// matrix, so the mask is needed, and no padded copy of x is made.
//
// Accumulation is in float for f32 data and in double for f64 data
// (promote(dtype, f32), as in the TPU kernel).  The output dtype is x's,
// which must equal data's.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxDiagonals = 256;
constexpr int kThreads = 256;

struct Offsets {
  int n;
  int d[kMaxDiagonals];
};

template <typename T>
struct Accum {
  using type = float;
};
template <>
struct Accum<double> {
  using type = double;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, int n, Offsets offs) {
  using A = typename Accum<T>::type;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T* col = data + i;  // data[k, i] at col[k * n]
  A acc = A(0);
#pragma unroll 8
  for (int k = 0; k < offs.n; ++k) {
    const int src = i + offs.d[k];
    const A xv = (src >= 0 && src < n) ? A(__ldg(x + src)) : A(0);
    acc += A(__ldg(col + (size_t)k * n)) * xv;
  }
  y[i] = T(acc);
}

template <typename T>
int launch(const void* data, const void* x, void* y, int k, int n,
           const int* offsets, void* stream) {
  if (k < 1 || k > kMaxDiagonals || n < 1 || offsets == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Offsets offs;
  offs.n = k;
  for (int t = 0; t < kMaxDiagonals; ++t) offs.d[t] = t < k ? offsets[t] : 0;

  const dim3 grid((n + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  dia_spmv_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(y), n, offs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dia_spmv_f32(const void* data, const void* x, void* y, int k,
                            int n, const int* offsets, void* stream) {
  return launch<float>(data, x, y, k, n, offsets, stream);
}

extern "C" int dia_spmv_f64(const void* data, const void* x, void* y, int k,
                            int n, const int* offsets, void* stream) {
  return launch<double>(data, x, y, k, n, offsets, stream);
}
