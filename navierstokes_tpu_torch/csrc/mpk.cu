// Fused matrix-powers sweep z = A^p x, p = 2..4 (kernel K4), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel navierstokes_tpu/ops/mpk_pallas.py::
// _spmpv_kernel (driven there by spmpv_dia_pallas and spm2v_dia_pallas, on
// the overlap-tiled operator of pretile_dia_overlap).  With the scalar-DIA
// operator A (data (K, n) row-major, offsets d_k, h = max |d_k|):
//
//     y_0 = x,   y_j[i] = sum_k data[k, i] * y_{j-1}[i + d_k],   z = y_p
//
// where y_{j-1}[i'] counts as 0 outside [0, n): the same function, in the
// same order over k, as p chained launches of K2 (csrc/dia.cu).
//
// Ghost-overlap row tiles, one CTA per tile [iT, iT+T): sweep j computes
// y_j on the frame [iT - (p-j)h, iT + T + (p-j)h) into shared memory, so
// each sweep's frame shrinks by h per side and the last one is the tile
// itself, written to z.  Sweep 1 reads x from global memory (L1/L2),
// masked to [0, n); the intermediates y_1..y_{p-1} never leave the CTA.
// Two frames ping-pong in dynamic shared memory: (T + 2(p-1)h) and
// (T + 2(p-2)h) values (one frame for p = 2).  Entries of a frame that lie
// outside [0, n) are written as exact zeros: DIA data is not zero there
// (scale_rows_dia and coarse_operator_dia leave nonzeros), and the TPU
// kernel's zero-padded overlap copy of A has no counterpart here.  There is
// no pretiled copy of A: a CTA reads rows [iT - (p-1)h, iT + T + (p-1)h) of
// the (K, n) data in place.
//
// What bounds it: bytes.  The TPU kernel held a tile's whole (K, T + 2(p-1)h)
// block of A in VMEM and so read A (T + 2(p-1)h)/T times.  A CTA's 227 KB
// of shared memory holds the frames of the intermediates but not A's block
// (81 diagonals), so each sweep reads the data rows of its own frame:
// p + p(p-1)h/T passes over A's rows in all, from L2 where A fits there
// (the matrix-6 A in f32, 38 MB, fits the 50 MB L2; in f64 it does not).
// The caller picks T (ops/mpk_fused.py): as large as the frames allow, but
// no larger than one tile per SM.  The offsets travel by value in the
// parameter block, as in csrc/dia.cu.  Accumulation in the data type
// (promote(dtype, f32)); f32 and f64.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdlib>

namespace {

constexpr int kMaxDiagonals = 256;
constexpr int kThreads = 512;
constexpr int kMaxPower = 4;

struct Offsets {
  int n;
  int d[kMaxDiagonals];
};

// dst[v] = y[f + v] for v in [0, len): the DIA product over the source
// vector src, which holds y_prev[i] at src[i - sf] for i in [sf, ...) and,
// when src_global, is the global x (indexed by i, masked to [0, n)).
template <typename T, bool kSrcGlobal>
__device__ __forceinline__ void sweep(const T* __restrict__ data,
                                      const T* __restrict__ src, int sf,
                                      T* __restrict__ dst, int f, int len,
                                      int n, const Offsets& offs) {
  for (int v = threadIdx.x; v < len; v += blockDim.x) {
    const int i = f + v;
    T acc = T(0);
    if (i >= 0 && i < n) {
      const T* col = data + i;  // data[k, i] at col[k * n]
#pragma unroll 8
      for (int k = 0; k < offs.n; ++k) {
        const int j = i + offs.d[k];
        T yv;
        if (kSrcGlobal) {
          yv = (j >= 0 && j < n) ? __ldg(src + j) : T(0);
        } else {
          yv = src[j - sf];  // zero outside [0, n) by construction
        }
        acc += __ldg(col + (size_t)k * n) * yv;
      }
    }
    dst[v] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmpv_kernel(const T* __restrict__ data, const T* __restrict__ x,
             T* __restrict__ z, int n, int power, int h, int tile,
             Offsets offs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const odd = reinterpret_cast<T*>(smem_raw);       // sweeps 1, 3
  T* const even = odd + tile + 2 * (power - 1) * h;    // sweep 2
  const int it = blockIdx.x * tile;

  // sweep 1: y_1 on [it - (p-1)h, it + T + (p-1)h)
  int f = it - (power - 1) * h;
  sweep<T, true>(data, x, 0, odd, f, tile + 2 * (power - 1) * h, n, offs);
  __syncthreads();
  for (int j = 2; j < power; ++j) {
    const int fj = it - (power - j) * h;
    const bool j_even = (j & 1) == 0;
    sweep<T, false>(data, j_even ? odd : even, f, j_even ? even : odd, fj,
                    tile + 2 * (power - j) * h, n, offs);
    __syncthreads();
    f = fj;
  }
  // last sweep: the tile's own rows, from sweep p-1's frame to global memory
  const int len = min(tile, n - it);
  sweep<T, false>(data, (power & 1) ? even : odd, f, z + it, it, len, n,
                  offs);
}

template <typename T>
int launch(const void* data, const void* x, void* z, int k, int n,
           const int* offsets, int power, int tile, void* stream) {
  if (k < 1 || k > kMaxDiagonals || n < 1 || offsets == nullptr ||
      power < 2 || power > kMaxPower || tile < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Offsets offs;
  offs.n = k;
  int h = 1;
  for (int t = 0; t < kMaxDiagonals; ++t) {
    offs.d[t] = t < k ? offsets[t] : 0;
    if (t < k) h = std::max(h, std::abs(offsets[t]));
  }
  const size_t frames = (size_t)tile + 2 * (power - 1) * h +
                        (power > 2 ? (size_t)tile + 2 * (power - 2) * h : 0);
  const size_t smem = frames * sizeof(T);
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(spmpv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((n + tile - 1) / tile);
  spmpv_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(z), n, power, h, tile, offs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mpk_spmpv_f32(const void* data, const void* x, void* z, int k,
                             int n, const int* offsets, int power, int tile,
                             void* stream) {
  return launch<float>(data, x, z, k, n, offsets, power, tile, stream);
}

extern "C" int mpk_spmpv_f64(const void* data, const void* x, void* z, int k,
                             int n, const int* offsets, int power, int tile,
                             void* stream) {
  return launch<double>(data, x, z, k, n, offsets, power, tile, stream);
}
