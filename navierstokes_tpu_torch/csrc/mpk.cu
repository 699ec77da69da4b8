// Fused matrix-powers sweep z = A^p x, p = 2..4 (kernel K4), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel navierstokes_tpu/ops/mpk_pallas.py::
// _spmpv_kernel (driven there by spmpv_dia_pallas and spm2v_dia_pallas, on
// the overlap-tiled operator of pretile_dia_overlap).  With the scalar-DIA
// operator A (data (K, n) row-major, offsets d_k):
//
//     y_0 = x,   y_j[i] = sum_k data[k, i] * y_{j-1}[i + d_k],   z = y_p
//
// where y_{j-1}[i'] counts as 0 outside [0, n): the same function, in the
// same order over k and with the same fused multiply-add per term, as p
// chained launches of K2 (csrc/dia.cu), so the two agree bit for bit.  DIA
// data is not zero where i + d_k leaves the matrix (scale_rows_dia and
// coarse_operator_dia leave nonzeros there), so the mask is needed.
//
// What bounds it: bytes.  A is read for one multiply-add per value; the
// function's bound reads it once.  The design is one persistent,
// cooperatively launched kernel (grid_sync.cuh), one block per SM at
// matrix 6, block b owning the row slab [r_b, r_{b+1}):
//
//   - Every pass first copies the window of its source that the block's
//     rows reach, [r_b + min d_k, r_{b+1} + max d_k), into shared memory,
//     with exact zeros outside [0, n) in place of the mask, so that the
//     81 reads of each row hit shared memory.  (A window wider than half
//     the shared memory is left out and the source read in place, masked.)
//   - Pass 1 also copies the slab of the first Kres diagonals of data into
//     shared memory, as many as fit beside the window (matrix 6: 58 of 81
//     in f32, 25 in f64), one bulk copy per diagonal (band_ring.cuh) where
//     every diagonal's slab starts on 16 bytes, plain loads otherwise.  The
//     diagonals arrive on one mbarrier per group of kGroup, and pass 1 sums
//     each group as it lands.
//   - Passes 2..p each follow one grid barrier (p - 1 in all).  Their
//     source y_{j-1} is a global ping-pong scratch of 2 n values
//     (L2-resident); the last pass writes z.
//   - The diagonals that did not fit are read from global memory in every
//     pass: from HBM in pass 1 and, where A's rest fits the 50 MB L2 (f32
//     at matrix 6), from L2 after.  So A's resident part comes from HBM
//     once and there is one launch, where p chained SpMVs read A p times
//     and launch p times, and ghost-overlap row tiles (one block per
//     tile, the intermediates in shared memory) read A's rows of every
//     frame again in every sweep (7.75-38 passes at matrix 6).  No halo,
//     no frames: any offsets run.
//
// A thread keeps the sums of up to kRowsPerThread rows in registers and
// walks the diagonals in K2's order for all of them, so that the groups of
// pass 1 can be summed as they land.  The offsets travel by value in the
// parameter block, as in csrc/dia.cu.  Accumulation in the data type
// (promote(dtype, f32)); f32 and f64.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "grid_sync.cuh"

namespace {

constexpr int kMaxDiagonals = 256;
constexpr int kThreads = 512;
constexpr int kRowsPerThread = 2;
constexpr int kGroup = 8;                    // diagonals per mbarrier
constexpr int kHeaderBytes = 256;            // the groups' mbarriers
constexpr int kMaxPower = 4;
static_assert(kMaxDiagonals <= kGroup * kHeaderBytes / 8,
              "a barrier per group of diagonals");

struct Offsets {
  int n;
  int d[kMaxDiagonals];
};

// Bytes of the source window in shared memory: `window` values, rounded
// up to 16 so that the resident diagonals after it start aligned.
__host__ __device__ inline int window_bytes(int window, int s) {
  return ((window * s + 15) / 16) * 16;
}

// acc[j] += row[v] * y[r0 + v + d] for the thread's rows v = base + j
// kThreads + tid below `rows`, y counting as 0 outside [0, n): one term of
// K2's sum, with K2's multiply-add.  Row `row` of the diagonal is in shared
// memory (kShared) or global memory.  y comes from the block's window in
// shared memory (kWindow: win[t] = y[r0 + dmin + t], exact zeros outside
// [0, n), which take the mask's place) or, where the window does not fit,
// from src in global memory, masked: in pass 1 (kFirst) src is x,
// read-only for the whole launch; after it, src is the previous pass's y,
// written by other blocks: plain loads (grid_sync.cuh).
template <typename T, bool kFirst, bool kShared, bool kWindow>
__device__ __forceinline__ void term(T (&acc)[kRowsPerThread], const T* row,
                                     const T* src, const T* win, int d,
                                     int dmin, int base, int r0, int rows,
                                     int n) {
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int v = base + j * kThreads + (int)threadIdx.x;
    if (v < rows) {
      T yv;
      if (kWindow) {
        yv = win[v + d - dmin];
      } else {
        const int s = r0 + v + d;
        yv = T(0);
        if (s >= 0 && s < n) yv = kFirst ? __ldg(src + s) : src[s];
      }
      const T a = kShared ? row[v] : __ldg(row + v);
      acc[j] += a * yv;
    }
  }
}

// dst[r0 + v] = sum_k data[k, r0 + v] * src[r0 + v + d_k] for v < rows, in
// K2's order over k: diagonals below kres from the slab in shared memory
// (ds, row stride ld), the rest from global memory.  With kWindow the
// block first copies src[r0 + dmin, r0 + rows + dmax) into win.  `wait`
// waits for each group of resident diagonals to land (pass 1, bulk
// copies).
template <typename T, bool kFirst, bool kWindow>
__device__ __forceinline__ void pass(const T* ds, int ld, const T* data,
                                     const T* src, T* win, int dmin,
                                     int span, T* dst, int r0, int rows,
                                     int n, int kres, const Offsets& offs,
                                     uint64_t* bars, bool wait) {
  if (kWindow) {
    for (int t = threadIdx.x; t < rows + span; t += kThreads) {
      const int g = r0 + dmin + t;
      T v = T(0);
      if (g >= 0 && g < n) v = kFirst ? __ldg(src + g) : src[g];
      win[t] = v;
    }
    __syncthreads();
  }
  for (int base = 0; base < rows; base += kThreads * kRowsPerThread) {
    T acc[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[j] = T(0);
    for (int g = 0; g * kGroup < kres; ++g) {
      if (wait && base == 0) band_ring::wait(bars + g, 0);
      const int k1 = min(kres, (g + 1) * kGroup);
#pragma unroll 4
      for (int k = g * kGroup; k < k1; ++k) {
        term<T, kFirst, true, kWindow>(acc, ds + (size_t)k * ld, src, win,
                                       offs.d[k], dmin, base, r0, rows, n);
      }
    }
#pragma unroll 4
    for (int k = kres; k < offs.n; ++k) {
      term<T, kFirst, false, kWindow>(acc, data + (size_t)k * n + r0, src,
                                      win, offs.d[k], dmin, base, r0, rows,
                                      n);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int v = base + j * kThreads + (int)threadIdx.x;
      if (v < rows) dst[r0 + v] = acc[j];
    }
  }
}

// The p passes, with a grid barrier before each after the first.
template <typename T, bool kWindow>
__device__ __forceinline__ void passes(const T* ds, int ld, const T* data,
                                       const T* x, T* z, T* ybuf, T* win,
                                       int dmin, int span, int r0, int rows,
                                       int n, int power, int kres,
                                       const Offsets& offs, uint64_t* bars,
                                       bool copies) {
  const size_t nn = (size_t)n;
  pass<T, true, kWindow>(ds, ld, data, x, win, dmin, span, ybuf, r0, rows, n,
                         kres, offs, bars, copies);
  for (int j = 2; j <= power; ++j) {
    grid_sync::grid_barrier();
    const T* src = ybuf + (size_t)((j - 2) & 1) * nn;
    T* out = j == power ? z : ybuf + (size_t)((j - 1) & 1) * nn;
    pass<T, false, kWindow>(ds, ld, data, src, win, dmin, span, out, r0,
                            rows, n, kres, offs, bars, false);
  }
}

// ybuf holds 2 n values (y_j in half (j - 1) % 2); it and z are written and
// read across blocks, so neither is const or __restrict__.  `window` is
// the length of the source window in shared memory (0: none), `dmin` the
// smallest offset.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
spmpv_kernel(const T* __restrict__ data, const T* __restrict__ x, T* z,
             T* ybuf, int n, int power, int kres, int window, int dmin,
             int bulk, Offsets offs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s = (int)sizeof(T);
  const int grid = gridDim.x;
  const int align = 16 / s;
  const int ld = grid_sync::max_slab(n, grid, align);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* win = reinterpret_cast<T*>(smem + kHeaderBytes);
  T* ds = reinterpret_cast<T*>(smem + kHeaderBytes + window_bytes(window, s));
  const int r0 = grid_sync::slab_begin(blockIdx.x, grid, n, align);
  const int rows = grid_sync::slab_begin(blockIdx.x + 1, grid, n, align) - r0;
  const size_t nn = (size_t)n;
  const bool copies = bulk && rows > 0 && kres > 0;

  // The slab of diagonals 0..kres-1 into shared memory.
  if (copies) {
    const int groups = (kres + kGroup - 1) / kGroup;
    if (threadIdx.x == 0) {
      for (int g = 0; g < groups; ++g) band_ring::init_barrier(bars + g, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const uint32_t bytes = (uint32_t)(rows * s);
      if (threadIdx.x == 0) {
        for (int g = 0; g < groups; ++g) {
          const int in_group = min(kGroup, kres - g * kGroup);
          band_ring::expect_bytes(bars + g, bytes * in_group);
        }
      }
      __syncwarp();
      for (int k = threadIdx.x; k < kres; k += 32) {
        band_ring::bulk_load(ds + (size_t)k * ld, data + k * nn + r0, bytes,
                             bars + k / kGroup);
      }
    }
  } else {
    for (int k = 0; k < kres; ++k) {
      for (int v = threadIdx.x; v < rows; v += kThreads) {
        ds[(size_t)k * ld + v] = data[k * nn + r0 + v];
      }
    }
    __syncthreads();
  }

  if (window > 0) {
    passes<T, true>(ds, ld, data, x, z, ybuf, win, dmin, window - ld, r0,
                    rows, n, power, kres, offs, bars, copies);
  } else {
    passes<T, false>(ds, ld, data, x, z, ybuf, win, dmin, 0, r0, rows, n,
                     power, kres, offs, bars, copies);
  }
}

// Per kernel instance and device: allowed the whole shared-memory opt-in.
template <typename T>
struct Allowed {
  static bool flags[band_ring::kDevices];
};
template <typename T>
bool Allowed<T>::flags[band_ring::kDevices] = {};

// `kres`, `window`, `grid` and `smem` are the wrapper's plan
// (ops/mpk_fused.py::plan, the grid from mpk_blocks_per_sm); checked again
// here.  ybuf holds 2 n values.
template <typename T>
int launch(const void* data, const void* x, void* z, void* ybuf, int k, int n,
           const int* offsets, int power, int kres, int window, int grid,
           int smem, void* stream) {
  if (k < 1 || k > kMaxDiagonals || n < 1 || offsets == nullptr ||
      power < 2 || power > kMaxPower || kres < 0 || kres > k || grid < 1 ||
      window < 0 || smem > band_ring::kSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  const int s = (int)sizeof(T);
  const int ld = grid_sync::max_slab(n, grid, 16 / s);
  int dmin = offsets[0];
  int dmax = offsets[0];
  for (int t = 1; t < k; ++t) {
    dmin = std::min(dmin, offsets[t]);
    dmax = std::max(dmax, offsets[t]);
  }
  if ((window > 0 && window < ld + dmax - dmin) ||
      kHeaderBytes + (long long)window_bytes(window, s) +
              (long long)kres * ld * s > smem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t rc = band_ring::allow_full_smem(spmpv_kernel<T>,
                                              Allowed<T>::flags);
  if (rc != cudaSuccess) return (int)rc;
  Offsets offs;
  offs.n = k;
  for (int t = 0; t < kMaxDiagonals; ++t) offs.d[t] = t < k ? offsets[t] : 0;
  const T* dp = static_cast<const T*>(data);
  const T* xp = static_cast<const T*>(x);
  T* zp = static_cast<T*>(z);
  T* yp = static_cast<T*>(ybuf);
  int bulk = (reinterpret_cast<uintptr_t>(data) % 16 == 0) &&
             ((size_t)n * sizeof(T)) % 16 == 0;
  void* args[] = {&dp,    &xp,   &zp,   &yp,   &n,   &power,
                  &kres,  &window, &dmin, &bulk, &offs};
  return (int)grid_sync::launch(spmpv_kernel<T>, grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream), args);
}

template <typename T>
int blocks_per_sm(int smem, int* out) {
  return (int)grid_sync::blocks_per_sm(spmpv_kernel<T>, kThreads, smem,
                                       Allowed<T>::flags, out);
}

bool floor_allowed[band_ring::kDevices] = {};

}  // namespace

extern "C" int mpk_spmpv_f32(const void* data, const void* x, void* z,
                             void* ybuf, int k, int n, const int* offsets,
                             int power, int kres, int window, int grid,
                             int smem, void* stream) {
  return launch<float>(data, x, z, ybuf, k, n, offsets, power, kres, window,
                       grid, smem, stream);
}

extern "C" int mpk_spmpv_f64(const void* data, const void* x, void* z,
                             void* ybuf, int k, int n, const int* offsets,
                             int power, int kres, int window, int grid,
                             int smem, void* stream) {
  return launch<double>(data, x, z, ybuf, k, n, offsets, power, kres, window,
                        grid, smem, stream);
}

// Blocks of K4 that one SM holds at `smem` bytes of dynamic shared memory.
extern "C" int mpk_blocks_per_sm_f32(int smem, int* out) {
  return blocks_per_sm<float>(smem, out);
}

extern "C" int mpk_blocks_per_sm_f64(int smem, int* out) {
  return blocks_per_sm<double>(smem, out);
}

// The floor of a persistent launch: grid_sync's empty kernel, `grid` blocks
// of K4's width and `smem` bytes, `barriers` grid barriers and nothing else.
extern "C" int grid_sync_floor(int grid, int smem, int barriers,
                               void* stream) {
  cudaError_t rc = band_ring::allow_full_smem(grid_sync::empty_kernel<>,
                                              floor_allowed);
  if (rc != cudaSuccess) return (int)rc;
  void* args[] = {&barriers};
  return (int)grid_sync::launch(grid_sync::empty_kernel<>, grid, kThreads,
                                smem, static_cast<cudaStream_t>(stream), args);
}
