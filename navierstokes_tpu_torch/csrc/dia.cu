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
// The ghost-row form (`ghost` = g > 0; the TPU kernel's x_prehalo=True, run
// per shard by the distributed solver, parallel/partitioned.py): x holds
// n + 2g values, x[g + j] for j in [-g, n + g), the g ghost rows on either
// side filled by the halo exchange from the neighbouring shards (zeros
// beyond the matrix).  With g >= max|off| every i + off lands inside that
// window, so nothing is masked: y[i] = sum_k data[k, i] * x[g + i + off_k].
// The terms are summed in the same order as in the masked form, so a
// shard's rows equal the rows of one launch on the whole vector bit for
// bit.  g = 0 is the masked form unchanged.
//
// Accumulation is in float for f32 data and in double for f64 data
// (promote(dtype, f32), as in the TPU kernel).  The output dtype is x's,
// which must equal data's.
//
// The bfloat16 operator form (`matvec_dtype='bfloat16'` on the 'tl' and
// 'bj' paths): data is bf16, x and y are f32 or f64, and the sum is taken
// in x's dtype (promote(x, f32)), diagonal by diagonal in the order given:
// the semantics of the JAX package's XLA `spmv_dia` on bf16 data and of
// its windowed Pallas form, which the TPU ran for the model (it pretiled
// bf16 data).  The non-windowed Pallas form rounds x to bf16 before the
// products (`pallas_dia.py`, `x.astype(data.dtype)`); only a direct call
// reached it, and that rounding is a TPU quirk this kernel does not copy.
// It halves the operator's bytes, so it is bound by bytes all the more.
// One thread per row would make 64-byte warp requests of 2-byte values and
// halve the bytes in flight, so each thread takes two adjacent rows
// (2t, 2t+1) and reads both values of a diagonal with one 4-byte
// __nv_bfloat162 load.  Diagonal k starts at element k * n, which is
// 4-byte aligned for every k only when n is even: an odd n (no operator of
// the solver has one; ndof = 4 nv) takes the same kernel with two 2-byte
// loads per diagonal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// kGhost: the ghost-row form, compiled apart so that the masked form's
// code is the one it always was.
template <typename T, bool kGhost>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, int n, int ghost, Offsets offs) {
  using A = typename Accum<T>::type;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T* col = data + i;  // data[k, i] at col[k * n]
  A acc = A(0);
#pragma unroll 8
  for (int k = 0; k < offs.n; ++k) {
    const int src = i + offs.d[k];
    const A xv = kGhost ? A(__ldg(x + ghost + src))
                 : (src >= 0 && src < n) ? A(__ldg(x + src)) : A(0);
    acc += A(__ldg(col + (size_t)k * n)) * xv;
  }
  y[i] = T(acc);
}

// The offsets a launch takes, or false: 1..kMaxDiagonals of them, and in
// the ghost-row form each within the ghost width.
bool pack(const int* offsets, int k, int n, int ghost, Offsets* offs) {
  if (k < 1 || k > kMaxDiagonals || n < 1 || ghost < 0 ||
      offsets == nullptr) {
    return false;
  }
  offs->n = k;
  for (int t = 0; t < kMaxDiagonals; ++t) {
    offs->d[t] = t < k ? offsets[t] : 0;
    if (ghost > 0 && (offs->d[t] > ghost || offs->d[t] < -ghost)) return false;
  }
  return true;
}

template <typename T>
int launch(const void* data, const void* x, void* y, int k, int n, int ghost,
           const int* offsets, void* stream) {
  Offsets offs;
  if (!pack(offsets, k, n, ghost, &offs)) return (int)cudaErrorInvalidValue;

  const dim3 grid((n + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  auto kernel =
      ghost > 0 ? dia_spmv_kernel<T, true> : dia_spmv_kernel<T, false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(y), n, ghost, offs);
  return (int)cudaGetLastError();
}

// Two rows per thread: rows i = 2t and i + 1 (when < n), bf16 data, x and
// y in T, the sum in T.  kPaired: n is even and data starts on 4 bytes, so
// data[k, i] does too and the pair is one __nv_bfloat162 load.
template <typename T, bool kPaired, bool kGhost>
__global__ void __launch_bounds__(kThreads)
dia_spmv_bf16_kernel(const __nv_bfloat16* __restrict__ data,
                     const T* __restrict__ x, T* __restrict__ y, int n,
                     int ghost, Offsets offs) {
  const int i = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const bool second = i + 1 < n;
  const __nv_bfloat16* col = data + i;  // data[k, i] at col[k * n]
  T acc0 = T(0), acc1 = T(0);
#pragma unroll 8
  for (int k = 0; k < offs.n; ++k) {
    const __nv_bfloat16* dk = col + (size_t)k * n;
    float d0, d1;
    if (kPaired) {
      const __nv_bfloat162 pair =
          __ldg(reinterpret_cast<const __nv_bfloat162*>(dk));
      d0 = __low2float(pair);
      d1 = __high2float(pair);
    } else {
      d0 = __bfloat162float(__ldg(dk));
      d1 = second ? __bfloat162float(__ldg(dk + 1)) : 0.0f;
    }
    const int src = i + offs.d[k];
    T x0, x1;
    if (kGhost) {
      x0 = __ldg(x + ghost + src);
      x1 = __ldg(x + ghost + src + 1);
    } else {
      x0 = (src >= 0 && src < n) ? __ldg(x + src) : T(0);
      x1 = (src + 1 >= 0 && src + 1 < n) ? __ldg(x + src + 1) : T(0);
    }
    acc0 += T(d0) * x0;
    acc1 += T(d1) * x1;
  }
  y[i] = acc0;
  if (second) y[i + 1] = acc1;
}

template <typename T>
int launch_bf16(const void* data, const void* x, void* y, int k, int n,
                int ghost, const int* offsets, void* stream) {
  Offsets offs;
  if (!pack(offsets, k, n, ghost, &offs)) return (int)cudaErrorInvalidValue;

  const int pairs = (n + 1) / 2;
  const dim3 grid((pairs + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  const auto* d = static_cast<const __nv_bfloat16*>(data);
  const auto* xs = static_cast<const T*>(x);
  auto* ys = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool paired = n % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(data) % 4 == 0;
  auto kernel = paired ? (ghost > 0 ? dia_spmv_bf16_kernel<T, true, true>
                                    : dia_spmv_bf16_kernel<T, true, false>)
                       : (ghost > 0 ? dia_spmv_bf16_kernel<T, false, true>
                                    : dia_spmv_bf16_kernel<T, false, false>);
  kernel<<<grid, block, 0, s>>>(d, xs, ys, n, ghost, offs);
  return (int)cudaGetLastError();
}

}  // namespace

// x holds n + 2 * ghost values (ghost = 0: n, the masked form).
extern "C" int dia_spmv_f32(const void* data, const void* x, void* y, int k,
                            int n, int ghost, const int* offsets,
                            void* stream) {
  return launch<float>(data, x, y, k, n, ghost, offsets, stream);
}

extern "C" int dia_spmv_f64(const void* data, const void* x, void* y, int k,
                            int n, int ghost, const int* offsets,
                            void* stream) {
  return launch<double>(data, x, y, k, n, ghost, offsets, stream);
}

extern "C" int dia_spmv_bf16_f32(const void* data, const void* x, void* y,
                                 int k, int n, int ghost, const int* offsets,
                                 void* stream) {
  return launch_bf16<float>(data, x, y, k, n, ghost, offsets, stream);
}

extern "C" int dia_spmv_bf16_f64(const void* data, const void* x, void* y,
                                 int k, int n, int ghost, const int* offsets,
                                 void* stream) {
  return launch_bf16<double>(data, x, y, k, n, ghost, offsets, stream);
}
