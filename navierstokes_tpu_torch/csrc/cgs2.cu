// Fused CGS2 projection (kernel K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels navierstokes_tpu/ops/cgs2_pallas.py::
// _s1_kernel, _s2_kernel and _s3_kernel (driven there by cgs2_project, with
// the helpers _masked, _window_ops and _lane_fold).  One projection of w
// against the live rows 0..k of the Krylov basis V (row-major (m1, n)):
//
//     h1 = V w;   w1 = w - V^T h1;   h2 = V w1;   w2 = w1 - V^T h2
//
// and h = h1 + h2, exactly zero in rows k+1..m1-1.  Rows above k are never
// read, so stale values there (NaN included) cannot leak.
//
// What bounds it: bytes.  The function reads the k+1 live rows of V once
// for three multiply-adds per value, far below the card's ridge point; at
// the GMRES shapes V[:k+1] is 7.5-28 MB.  The design is one persistent,
// cooperatively launched kernel (grid_sync.cuh), one block per SM at the
// GMRES shapes, block b owning the column slab [c_b, c_{b+1}):
//
//   1. The block copies the slab of rows 0..R-1 and of w into shared
//      memory, where R = min(k+1, what fits), one bulk copy per row
//      (band_ring.cuh) where every row's slab starts on 16 bytes
//      (n * sizeof(T) a multiple of 16, V and w aligned), plain loads
//      otherwise.  The rows arrive on one mbarrier per group of kWarps
//      rows (w with the first), so the h1 partials of the first rows are
//      taken while the later ones land.  Block b writes the partial of row
//      r over its slab to part1[r, b].
//   2. Grid barrier.  Every block folds part1[0..k, 0..G) in the same
//      fixed order (a warp per row), so every block holds a bit-identical
//      h1 with no second barrier and no atomics.
//   3. w1 = w - V_slab^T h1 from shared memory (a thread per column), kept
//      in shared memory in w's place: w1 never goes to global memory where
//      its slab fits (always, up to n of several million; above that w is
//      read in place and w1 lives in w2's own slab until phase 5
//      overwrites it).  The h2 partials go to
//      part2 (a second region: another block may still be folding part1).
//   4. Grid barrier, fold of h2 as in 2.
//   5. w2 = w1 - V_slab^T h2, written out; block 0 writes h.
//
// So V comes from HBM once and there is one launch, where a design of
// separate sweeps makes five launches (three sweeps, two folds) and reads
// V three times.
// Rows R..k that did not fit (large n) are read from global memory in
// every phase.  Nothing carries over between launches but the barrier
// word, and a run repeats bit for bit.
//
// compensated != 0 takes every h sum (the per-lane accumulation, the warp
// reduction and the fold over blocks) as a compensated (TwoSum) sum, the
// counterpart of _lane_fold(compensated=True).  The w - V^T h sums stay
// plain, as in _s2/_s3.  The compensated arithmetic uses the _rn
// intrinsics, so the compiler can neither contract it into FMAs nor
// reassociate it; the library is built without --use_fast_math.
//
// Accumulation is in the data type (float for f32, double for f64), which
// is promote(dtype, f32) for both.  f32 and f64, any n, m1 <= kMaxRows.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "grid_sync.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 512;
constexpr int kHeaderBytes = 256;           // the row groups' mbarriers
constexpr int kMaxGroups = kHeaderBytes / 8;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kMaxRows <= kMaxGroups * kWarps, "a barrier per row group");

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

// sum_{c < cols} row[c] * x[c] by one warp, the result in lane 0.
template <typename T, bool COMP>
__device__ __forceinline__ T row_dot(const T* row, const T* x, int cols) {
  Sum<T, COMP> acc;
  for (int c = threadIdx.x & 31; c < cols; c += 32) acc.add_prod(row[c], x[c]);
  return warp_sum(acc).value();
}

// Shared memory, in bytes from the start: the mbarriers, h1 and h2 (k+1
// values each), w1's slab where it fits, then R rows of `ld` values.
// ops/cgs2.py::plan mirrors this.
struct Layout {
  int h, w1, v, total;
};

__host__ __device__ inline Layout layout(int k, int ld, int rows,
                                         int w1_shared, int s) {
  Layout l;
  l.h = kHeaderBytes;
  l.w1 = l.h + ((2 * (k + 1) * s + 15) / 16) * 16;
  l.v = l.w1 + (w1_shared ? ld * s : 0);
  l.total = l.v + rows * ld * s;
  return l;
}

// The partials of rows 0..k over this block's slab: rows below `rows` from
// shared memory (where `bulk`, waiting for the first group's copies, which
// bring x, and then for each row's group), the rest from V in global
// memory.  part[r * G + b].
template <typename T, bool COMP>
__device__ __forceinline__ void partials(const T* vs, int ld, const T* V,
                                         size_t n, int c0, int cols, int k,
                                         int rows, const T* x, bool bulk,
                                         uint64_t* bars, T* part) {
  const int warp = threadIdx.x >> 5;
  if (bulk) band_ring::wait(bars, 0);
  for (int r = warp; r <= k; r += kWarps) {
    T v;
    if (r < rows) {
      if (bulk) band_ring::wait(bars + r / kWarps, 0);
      v = row_dot<T, COMP>(vs + (size_t)r * ld, x, cols);
    } else {
      v = row_dot<T, COMP>(V + (size_t)r * n + c0, x, cols);
    }
    if ((threadIdx.x & 31) == 0) part[(size_t)r * gridDim.x + blockIdx.x] = v;
  }
}

// Every block: out[r] = the fixed-order sum over blocks of part[r, :], for
// r = 0..k, a warp per row.  `part` was written by other blocks before the
// last grid barrier: plain loads.
template <typename T, bool COMP>
__device__ __forceinline__ void fold(const T* part, int k, T* out) {
  const int warp = threadIdx.x >> 5;
  const int grid = gridDim.x;
  for (int r = warp; r <= k; r += kWarps) {
    Sum<T, COMP> acc;
    for (int t = threadIdx.x & 31; t < grid; t += 32) {
      acc.add(part[(size_t)r * grid + t]);
    }
    acc = warp_sum(acc);
    if ((threadIdx.x & 31) == 0) out[r] = acc.value();
  }
  __syncthreads();
}

// x[c] - sum_{r <= k} V[r, c0 + c] * h[r], rows below `rows` from shared
// memory.
template <typename T>
__device__ __forceinline__ T project_column(const T* vs, int ld, const T* V,
                                            size_t n, int c0, int c, int k,
                                            int rows, const T* h, T x) {
  T s = T(0);
#pragma unroll 4
  for (int r = 0; r < rows; ++r) s += vs[(size_t)r * ld + c] * h[r];
  for (int r = rows; r <= k; ++r) s += V[(size_t)r * n + c0 + c] * h[r];
  return x - s;
}

// `part` holds 2 (k+1) G values: the h1 partials, then the h2 partials.
// It is written and read across blocks, so it is neither const nor
// __restrict__ (see grid_sync.cuh).  w2 is not __restrict__ either: where
// w1 does not fit in shared memory it lives in w2's slab.
template <typename T, bool COMP>
__global__ void __launch_bounds__(kThreads, 1)
cgs2_kernel(const T* __restrict__ V, const T* __restrict__ w, T* w2,
            T* __restrict__ h, T* part, int n, int m1, int k, int rows,
            int w1_shared, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s = (int)sizeof(T);
  const int grid = gridDim.x;
  const int align = 16 / s;
  const int ld = grid_sync::max_slab(n, grid, align);
  const Layout lay = layout(k, ld, rows, w1_shared, s);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* h1 = reinterpret_cast<T*>(smem + lay.h);
  T* h2 = h1 + (k + 1);
  T* vs = reinterpret_cast<T*>(smem + lay.v);
  const int c0 = grid_sync::slab_begin(blockIdx.x, grid, n, align);
  const int cols = grid_sync::slab_begin(blockIdx.x + 1, grid, n, align) - c0;
  T* w1 = w1_shared ? reinterpret_cast<T*>(smem + lay.w1) : w2 + c0;
  T* part1 = part;
  T* part2 = part + (size_t)(k + 1) * grid;
  const size_t nn = (size_t)n;
  const bool copies = bulk && cols > 0 && rows > 0;

  // 1. rows 0..R-1 of the slab into shared memory; h1 partials
  // w's slab goes to w1's place (which phase 3 overwrites in place) with
  // the first group of rows; where it does not fit, w is read in place.
  const T* ws = w1_shared ? w1 : w + c0;
  if (copies) {
    const int groups = (rows + kWarps - 1) / kWarps;
    if (threadIdx.x == 0) {
      for (int g = 0; g < groups; ++g) band_ring::init_barrier(bars + g, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const uint32_t row_bytes = (uint32_t)(cols * s);
      if (threadIdx.x == 0) {
        for (int g = 0; g < groups; ++g) {
          const int in_group = min(kWarps, rows - g * kWarps) +
                               (g == 0 && w1_shared ? 1 : 0);
          band_ring::expect_bytes(bars + g, row_bytes * in_group);
        }
        if (w1_shared) band_ring::bulk_load(w1, w + c0, row_bytes, bars);
      }
      __syncwarp();
      for (int r = threadIdx.x; r < rows; r += 32) {
        band_ring::bulk_load(vs + (size_t)r * ld, V + r * nn + c0, row_bytes,
                             bars + r / kWarps);
      }
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      for (int c = threadIdx.x; c < cols; c += kThreads) {
        vs[(size_t)r * ld + c] = V[r * nn + c0 + c];
      }
    }
    if (w1_shared) {
      for (int c = threadIdx.x; c < cols; c += kThreads) w1[c] = w[c0 + c];
    }
    __syncthreads();
  }
  partials<T, COMP>(vs, ld, V, nn, c0, cols, k, rows, ws, copies, bars,
                    part1);

  // 2. h1 in every block
  grid_sync::grid_barrier();
  fold<T, COMP>(part1, k, h1);

  // 3. w1 and the h2 partials
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    w1[c] = project_column(vs, ld, V, nn, c0, c, k, rows, h1, ws[c]);
  }
  __syncthreads();
  partials<T, COMP>(vs, ld, V, nn, c0, cols, k, rows, w1, false, bars, part2);

  // 4. h2 in every block
  grid_sync::grid_barrier();
  fold<T, COMP>(part2, k, h2);

  // 5. w2 and h
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    w2[c0 + c] = project_column(vs, ld, V, nn, c0, c, k, rows, h2, w1[c]);
  }
  if (blockIdx.x == 0) {
    for (int r = threadIdx.x; r < m1; r += kThreads) {
      h[r] = r <= k ? h1[r] + h2[r] : T(0);
    }
  }
}

// Per kernel instance and device: allowed the whole shared-memory opt-in.
template <typename T, bool COMP>
struct Allowed {
  static bool flags[band_ring::kDevices];
};
template <typename T, bool COMP>
bool Allowed<T, COMP>::flags[band_ring::kDevices] = {};

template <typename T, bool COMP>
int launch_one(const T* V, const T* w, T* w2, T* h, T* part, int n, int m1,
               int k, int rows, int w1_shared, int grid, int smem,
               cudaStream_t stream) {
  cudaError_t rc = band_ring::allow_full_smem(cgs2_kernel<T, COMP>,
                                              Allowed<T, COMP>::flags);
  if (rc != cudaSuccess) return (int)rc;
  int bulk = (reinterpret_cast<uintptr_t>(V) % 16 == 0) &&
             (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
             ((size_t)n * sizeof(T)) % 16 == 0;
  void* args[] = {&V, &w, &w2, &h, &part, &n, &m1, &k, &rows, &w1_shared,
                  &bulk};
  return (int)grid_sync::launch(cgs2_kernel<T, COMP>, grid, kThreads, smem,
                                stream, args);
}

// `rows` (R), `w1_shared`, `grid` and `smem` are the wrapper's plan
// (ops/cgs2.py::plan, the grid from cgs2_blocks_per_sm); checked again
// here.  part holds 2 (k+1) grid values, w2 n and h m1.
template <typename T>
int launch(const void* V, const void* w, void* w2, void* h, void* part, int n,
           int m1, int k, int rows, int w1_shared, int grid, int smem,
           int compensated, void* stream) {
  if (n < 1 || m1 < 1 || m1 > kMaxRows || k < 0 || k >= m1 || rows < 0 ||
      rows > k + 1 || grid < 1 || smem > band_ring::kSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  const int ld = grid_sync::max_slab(n, grid, 16 / (int)sizeof(T));
  if (layout(k, ld, rows, w1_shared, sizeof(T)).total > smem) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const T* Vp = static_cast<const T*>(V);
  const T* wp = static_cast<const T*>(w);
  T* w2p = static_cast<T*>(w2);
  T* hp = static_cast<T*>(h);
  T* pp = static_cast<T*>(part);
  if (compensated) {
    return launch_one<T, true>(Vp, wp, w2p, hp, pp, n, m1, k, rows, w1_shared,
                               grid, smem, st);
  }
  return launch_one<T, false>(Vp, wp, w2p, hp, pp, n, m1, k, rows, w1_shared,
                              grid, smem, st);
}

template <typename T>
int blocks_per_sm(int compensated, int smem, int* out) {
  if (compensated) {
    return (int)grid_sync::blocks_per_sm(cgs2_kernel<T, true>, kThreads,
                                         smem, Allowed<T, true>::flags, out);
  }
  return (int)grid_sync::blocks_per_sm(cgs2_kernel<T, false>, kThreads, smem,
                                       Allowed<T, false>::flags, out);
}

}  // namespace

extern "C" int cgs2_project_f32(const void* V, const void* w, void* w2,
                                void* h, void* part, int n, int m1, int k,
                                int rows, int w1_shared, int grid, int smem,
                                int compensated, void* stream) {
  return launch<float>(V, w, w2, h, part, n, m1, k, rows, w1_shared, grid,
                       smem, compensated, stream);
}

extern "C" int cgs2_project_f64(const void* V, const void* w, void* w2,
                                void* h, void* part, int n, int m1, int k,
                                int rows, int w1_shared, int grid, int smem,
                                int compensated, void* stream) {
  return launch<double>(V, w, w2, h, part, n, m1, k, rows, w1_shared, grid,
                        smem, compensated, stream);
}

// Blocks of K3 that one SM holds at `smem` bytes of dynamic shared memory.
extern "C" int cgs2_blocks_per_sm_f32(int compensated, int smem, int* out) {
  return blocks_per_sm<float>(compensated, smem, out);
}

extern "C" int cgs2_blocks_per_sm_f64(int compensated, int smem, int* out) {
  return blocks_per_sm<double>(compensated, smem, out);
}
