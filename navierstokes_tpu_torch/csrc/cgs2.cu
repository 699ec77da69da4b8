// Fused CGS2 projection (kernel K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels navierstokes_tpu/ops/cgs2_pallas.py::
// _s1_kernel, _s2_kernel and _s3_kernel (driven there by cgs2_project, with
// the helpers _masked, _window_ops and _lane_fold).  One projection of w
// against the live rows 0..k of the Krylov basis V (row-major (m1, n)):
//
//     sweep 1:  h1 = V w
//     sweep 2:  w1 = w - V^T h1;  h2 = V w1     (one read of V for both)
//     sweep 3:  w2 = w1 - V^T h2
//
// and h = h1 + h2, exactly zero in rows k+1..m1-1.  Rows above k are never
// read, so stale values there (NaN included) cannot leak.
//
// What bounds it: bytes.  Each sweep reads the k+1 live rows of V once
// (3(k+1) n values in all) for one multiply-add per value, far below the
// card's ridge point.  The design:
//
//   - The columns are cut into tiles of tc columns (a power of two, 32 to
//     512), one CTA each, min(tc, 256) threads.  Nothing carries over from
//     one CTA to the next, unlike the TPU's sequential grid, so each h sum
//     is taken in two steps: every CTA writes one partial per live row
//     (part[r, tile]), and a fold launch sums the partials of each row in a
//     fixed order (the XLA-side jnp.sum of cgs2_pallas.py:220,234).  No
//     atomics: a run repeats bit for bit.
//   - Sweep 2 copies its tile of the live rows into shared memory while it
//     forms w1 (thread per column, loop over rows), then takes the h2
//     partials from shared memory (warp per row, shuffle reduction).  tc is
//     chosen by the caller so that (k+1) tc values fit.
//   - Rows are read coalesced: a warp reads 32 neighbouring columns of one
//     row.
//
// compensated != 0 takes every h sum (the per-lane accumulation, the warp
// and CTA reductions and the fold over tiles) as a compensated (TwoSum)
// sum, the counterpart of _lane_fold(compensated=True).  The w - V^T h sums
// stay plain, as in _s2/_s3.  The compensated arithmetic uses the _rn
// intrinsics, so the compiler can neither contract it into FMAs nor
// reassociate it; the library is built without --use_fast_math.
//
// Accumulation is in the data type (float for f32, double for f64), which
// is promote(dtype, f32) for both.  f32 and f64, any n, m1 <= kMaxRows.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxRows = 512;
constexpr int kMinTile = 32;
constexpr int kMaxTile = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// A running sum s with its rounding error c (value s + c).  Plain: c stays 0
// and add() is one fused multiply-add.  Compensated: TwoSum (Knuth) on every
// add and every merge.
template <typename T, bool COMP>
struct Sum {
  T s = T(0);
  T c = T(0);

  __device__ __forceinline__ void two_sum(T b) {
    const T t = add_rn(s, b);
    const T bp = sub_rn(t, s);
    const T e = add_rn(sub_rn(s, sub_rn(t, bp)), sub_rn(b, bp));
    s = t;
    c = add_rn(c, e);
  }
  __device__ __forceinline__ void add_prod(T a, T b) {
    if (COMP) {
      two_sum(mul_rn(a, b));
    } else {
      s += a * b;
    }
  }
  __device__ __forceinline__ void add(T b) {
    if (COMP) {
      two_sum(b);
    } else {
      s += b;
    }
  }
  __device__ __forceinline__ void merge(const Sum& o) {
    if (COMP) {
      two_sum(o.s);
      c = add_rn(c, o.c);
    } else {
      s += o.s;
    }
  }
  __device__ __forceinline__ T value() const { return COMP ? add_rn(s, c) : s; }
};

// Fixed-order tree over the 32 lanes; the result is in lane 0.
template <typename T, bool COMP>
__device__ __forceinline__ Sum<T, COMP> warp_sum(Sum<T, COMP> v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Sum<T, COMP> o;
    o.s = __shfl_down_sync(kFull, v.s, off);
    if (COMP) o.c = __shfl_down_sync(kFull, v.c, off);
    v.merge(o);
  }
  return v;
}

// part[r * ntiles + tile] = sum_{c < cols} row_r[c] * x[c] for r = 0..k,
// one warp per row (rows warp, warp + nwarps, ...).  row_r = src + r * ld.
template <typename T, bool COMP>
__device__ void row_partials(const T* src, size_t ld, const T* x, int cols,
                             int k, T* part, int ntiles) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r <= k; r += nwarps) {
    const T* row = src + (size_t)r * ld;
    Sum<T, COMP> acc;
    for (int c = lane; c < cols; c += 32) acc.add_prod(row[c], x[c]);
    acc = warp_sum(acc);
    if (lane == 0) part[(size_t)r * ntiles + blockIdx.x] = acc.value();
  }
}

// Sweep 1: the h1 partials of one column tile.
template <typename T, bool COMP>
__global__ void __launch_bounds__(kMaxThreads)
s1_kernel(const T* __restrict__ V, const T* __restrict__ w, T* __restrict__ part,
          int n, int k, int tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // w on this tile
  const int c0 = blockIdx.x * tc;
  const int cols = min(tc, n - c0);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) xs[c] = w[c0 + c];
  __syncthreads();
  row_partials<T, COMP>(V + c0, (size_t)n, xs, cols, k, part, gridDim.x);
}

// Sweep 2: w1 = w - V^T h1 on one column tile, the tile's live rows kept in
// shared memory, then the h2 partials from them.
template <typename T, bool COMP>
__global__ void __launch_bounds__(kMaxThreads)
s2_kernel(const T* __restrict__ V, const T* __restrict__ w,
          const T* __restrict__ h1, T* __restrict__ w1, T* __restrict__ part,
          int n, int k, int tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vs = reinterpret_cast<T*>(smem_raw);  // (k+1, tc) live rows of the tile
  T* xs = vs + (size_t)(k + 1) * tc;       // w1 on this tile
  T* hs = xs + tc;                         // h1[0..k]
  const int c0 = blockIdx.x * tc;
  const int cols = min(tc, n - c0);
  for (int r = threadIdx.x; r <= k; r += blockDim.x) hs[r] = h1[r];
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const T* col = V + c0 + c;
    T s = T(0);
#pragma unroll 4
    for (int r = 0; r <= k; ++r) {
      const T v = col[(size_t)r * n];
      vs[r * tc + c] = v;
      s += v * hs[r];
    }
    const T w1c = w[c0 + c] - s;
    xs[c] = w1c;
    w1[c0 + c] = w1c;
  }
  __syncthreads();
  row_partials<T, COMP>(vs, (size_t)tc, xs, cols, k, part, gridDim.x);
}

// Sweep 3: w2 = w1 - V^T h2.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
s3_kernel(const T* __restrict__ V, const T* __restrict__ w1,
          const T* __restrict__ h2, T* __restrict__ w2, int n, int k, int tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);
  const int c0 = blockIdx.x * tc;
  const int cols = min(tc, n - c0);
  for (int r = threadIdx.x; r <= k; r += blockDim.x) hs[r] = h2[r];
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const T* col = V + c0 + c;
    T s = T(0);
#pragma unroll 4
    for (int r = 0; r <= k; ++r) s += col[(size_t)r * n] * hs[r];
    w2[c0 + c] = w1[c0 + c] - s;
  }
}

// One CTA per row r of h: out[r] = sum over the tiles of part[r, :] in a
// fixed order and, where prev is given, total[r] = prev[r] + out[r].  Rows
// above k are exactly 0.
template <typename T, bool COMP>
__global__ void __launch_bounds__(kMaxThreads)
fold_kernel(const T* __restrict__ part, int ntiles, int k,
            T* __restrict__ out, const T* __restrict__ prev,
            T* __restrict__ total) {
  __shared__ T ss[kMaxThreads / 32];
  __shared__ T sc[kMaxThreads / 32];
  const int r = blockIdx.x;
  if (r > k) {
    if (threadIdx.x == 0) {
      out[r] = T(0);
      if (prev != nullptr) total[r] = T(0);
    }
    return;
  }
  Sum<T, COMP> acc;
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
    acc.add(part[(size_t)r * ntiles + t]);
  }
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    ss[warp] = acc.s;
    sc[warp] = acc.c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Sum<T, COMP> tot;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      Sum<T, COMP> o;
      o.s = ss[i];
      o.c = sc[i];
      tot.merge(o);
    }
    const T v = tot.value();
    out[r] = v;
    if (prev != nullptr) total[r] = prev[r] + v;
  }
}

bool valid_tile(int tc) {
  return tc >= kMinTile && tc <= kMaxTile && (tc & (tc - 1)) == 0;
}

template <typename T, bool COMP>
int project(const T* V, const T* w, T* w1, T* w2, T* hbuf, T* h, T* part,
            int n, int m1, int k, int tc, cudaStream_t stream) {
  const int ntiles = (n + tc - 1) / tc;
  const int threads = tc < kMaxThreads ? tc : kMaxThreads;
  const size_t smem2 = ((size_t)(k + 1) * tc + tc + (k + 1)) * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      s2_kernel<T, COMP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem2);
  if (err != cudaSuccess) return (int)err;
  T* h1 = hbuf;
  T* h2 = hbuf + m1;

  s1_kernel<T, COMP><<<ntiles, threads, tc * sizeof(T), stream>>>(
      V, w, part, n, k, tc);
  fold_kernel<T, COMP><<<m1, kMaxThreads, 0, stream>>>(part, ntiles, k, h1,
                                                       nullptr, nullptr);
  s2_kernel<T, COMP><<<ntiles, threads, smem2, stream>>>(V, w, h1, w1, part,
                                                         n, k, tc);
  fold_kernel<T, COMP><<<m1, kMaxThreads, 0, stream>>>(part, ntiles, k, h2,
                                                       h1, h);
  s3_kernel<T><<<ntiles, threads, (k + 1) * sizeof(T), stream>>>(
      V, w1, h2, w2, n, k, tc);
  return (int)cudaGetLastError();
}

// hbuf holds h1 and h2 (2 * m1 values), part the per-tile partials
// ((k+1) * ceil(n / tc) values); w1 and w2 have n values, h has m1.
template <typename T>
int launch(const void* V, const void* w, void* w1, void* w2, void* hbuf,
           void* h, void* part, int n, int m1, int k, int tc,
           int compensated, void* stream) {
  if (n < 1 || m1 < 1 || m1 > kMaxRows || k < 0 || k >= m1 ||
      !valid_tile(tc)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const T* Vp = static_cast<const T*>(V);
  const T* wp = static_cast<const T*>(w);
  T* w1p = static_cast<T*>(w1);
  T* w2p = static_cast<T*>(w2);
  T* hbp = static_cast<T*>(hbuf);
  T* hp = static_cast<T*>(h);
  T* pp = static_cast<T*>(part);
  if (compensated) {
    return project<T, true>(Vp, wp, w1p, w2p, hbp, hp, pp, n, m1, k, tc, s);
  }
  return project<T, false>(Vp, wp, w1p, w2p, hbp, hp, pp, n, m1, k, tc, s);
}

}  // namespace

extern "C" int cgs2_project_f32(const void* V, const void* w, void* w1,
                                void* w2, void* hbuf, void* h, void* part,
                                int n, int m1, int k, int tc, int compensated,
                                void* stream) {
  return launch<float>(V, w, w1, w2, hbuf, h, part, n, m1, k, tc,
                       compensated, stream);
}

extern "C" int cgs2_project_f64(const void* V, const void* w, void* w1,
                                void* w2, void* hbuf, void* h, void* part,
                                int n, int m1, int k, int tc, int compensated,
                                void* stream) {
  return launch<double>(V, w, w1, w2, hbuf, h, part, n, m1, k, tc,
                        compensated, stream);
}
