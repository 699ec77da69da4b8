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
// 132 SMs.  A variant that streamed the operator through a shared-memory
// ring of 1-D bulk copies (the design of K1's tiled route, band_ring.cuh)
// was built and timed on an H100 against this kernel: level from ~470k
// rows up, slower below and whenever the operator is warm in the L2
// (PERF.md), so it was not kept.
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
//
// Two routes compute every form above, each row's terms added in the given
// order of k as fma(data, x, acc), so that they agree bit for bit:
//
//   * 'rows' (dia_spmv_*): the kernels above.  A thread has at most 8
//     diagonals' loads in flight (`#pragma unroll 8`, one iteration's loads
//     issued together and waited for before the next's), so 81 diagonals
//     take ~10 memory round trips in sequence and 123 take ~16.
//   * 'tiled' (dia_spmv_tiled_*): one block per tile of `tn` rows (one a
//     thread, two for bf16 data), tiles of whole warps sized by the wrapper
//     to fill the card in whole waves (a shard of 29,376 rows: 132 tiles of
//     224).  The diagonals go in chunks of kDepth = 16: a thread's loads of
//     the next chunk, operator values and x together, are issued before it
//     sums the chunk in hand, so about 32 loads a thread overlap and the
//     round trips fall to ~K / 16; the K % 16 diagonals past the last whole
//     chunk are summed one at a time.  Registers only: no shared memory,
//     no barrier, nothing that waits on another thread.
//
// Designs tried on an H100 and not kept: the operator staged through a
// shared-memory ring with per-thread `cp.async` copies and the x window in
// shared memory (issuing a stage of copies held each block up longer than
// the loads it hid); registers fed in chunks but x read from a window in
// shared memory (a dependent position lookup before every x read: slower
// where the operator is warm in the L2); deeper unrolling of the 'rows'
// loop (no better at 16, slower at 32); loads that skip the L1.  The
// wrapper (ops/dia.py dia_route) picks the route by form, ghost rows, size
// and alignment, from the two routes' times in turns on an H100:
// 'tiled' where few rows fall to each SM (a shard) or the data is bf16
// with f32 x; `route=` forces one.  Nothing falls back from one to the
// other.

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

// --------------------------------------------------------------- tiled route

constexpr int kMaxThreads = 256;    // a tile's threads (rows, or row pairs)
constexpr int kDepth = 16;          // diagonals of a chunk

// Rows a thread owns: two adjacent rows of bf16 data (one 4-byte load a
// diagonal), else one; and what it loads of one diagonal.
template <typename TD>
struct Row {
  static constexpr int kRows = 1;
  using Load = TD;
};
template <>
struct Row<__nv_bfloat16> {
  static constexpr int kRows = 2;
  using Load = __nv_bfloat162;
};

// acc + d * x with one rounding: `acc += d * x` as nvcc contracts it in the
// 'rows' kernels.
__device__ __forceinline__ float madd(float d, float x, float acc) {
  return fmaf(d, x, acc);
}
__device__ __forceinline__ double madd(double d, double x, double acc) {
  return fma(d, x, acc);
}

// One tile of tn rows a block, a thread per row (per pair of bf16 rows).
// The diagonals go in chunks of kDepth: a thread's loads of a whole chunk,
// operator values and x alike, are in flight while it sums the chunk
// before, so about 2 * kDepth loads a thread overlap instead of the 'rows'
// kernels' 8; the last K % kDepth diagonals are summed one at a time.  No
// shared memory, no barrier.  The terms are added in the order of k.
template <typename TD, typename TX, bool kGhost>
__global__ void __launch_bounds__(kMaxThreads)
dia_spmv_tiled_kernel(const TD* __restrict__ data, const TX* __restrict__ x,
                      TX* __restrict__ y, int n, int ghost, int tn,
                      Offsets offs) {
  constexpr int R = Row<TD>::kRows;
  constexpr int P = kDepth;
  using L = typename Row<TD>::Load;
  const int r = (int)threadIdx.x * R;
  const int i = (int)blockIdx.x * tn + r;
  if (r >= tn || i >= n) return;
  const L* col = reinterpret_cast<const L*>(data + i);   // data[k, i]
  const size_t stride = (size_t)n / R;                  // in L
  const int k_all = offs.n;

  // x[i + q + off_k]: zero outside [0, n) in the masked form
  auto x_at = [&](int k, int q) -> TX {
    const int src = i + q + offs.d[k];
    return kGhost ? __ldg(x + ghost + src)
           : (src >= 0 && src < n) ? __ldg(x + src) : TX(0);
  };
  L a[P], b[P];
  TX xa[P][R], xb[P][R];
  auto load = [&](L (&d)[P], TX (&xv)[P][R], int c) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      d[j] = __ldg(col + (size_t)(c + j) * stride);
#pragma unroll
      for (int q = 0; q < R; ++q) xv[j][q] = x_at(c + j, q);
    }
  };
  TX acc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) acc[q] = TX(0);
  auto add = [&](const L& d, const TX (&xv)[R]) {
    if constexpr (R == 2) {
      acc[0] = madd(TX(__low2float(d)), xv[0], acc[0]);
      acc[1] = madd(TX(__high2float(d)), xv[1], acc[1]);
    } else {
      acc[0] = madd(TX(d), xv[0], acc[0]);
    }
  };
  auto sum = [&](const L (&d)[P], const TX (&xv)[P][R]) {
#pragma unroll
    for (int j = 0; j < P; ++j) add(d[j], xv[j]);
  };

  const int full = k_all / P * P;     // diagonals in whole chunks
  int c = 0;
  if (full > 0) {
    load(a, xa, 0);
    for (; c + 2 * P <= full; c += 2 * P) {
      load(b, xb, c + P);
      sum(a, xa);
      if (c + 2 * P < full) load(a, xa, c + 2 * P);
      sum(b, xb);
    }
    if (c < full) {
      sum(a, xa);
      c += P;
    }
  }
  for (; c < k_all; ++c) {
    TX xv[R];
#pragma unroll
    for (int q = 0; q < R; ++q) xv[q] = x_at(c, q);
    add(__ldg(col + (size_t)c * stride), xv);
  }
#pragma unroll
  for (int q = 0; q < R; ++q) y[i + q] = acc[q];
}

// `tn` is the wrapper's tile plan (ops/dia.py tile_plan); what it must
// satisfy is checked again here.
template <typename TD, typename TX>
int launch_tiled(const void* data, const void* x, void* y, int k, int n,
                 int ghost, const int* offsets, int tn, void* stream) {
  constexpr int R = Row<TD>::kRows;
  const int threads = (tn / R + 31) / 32 * 32;   // whole warps
  Offsets offs;
  if (!pack(offsets, k, n, ghost, &offs) || tn < 32 || tn % 32 != 0 ||
      threads > kMaxThreads || n % R != 0 ||
      reinterpret_cast<uintptr_t>(data) % (R * sizeof(TD)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = ghost > 0 ? dia_spmv_tiled_kernel<TD, TX, true>
                          : dia_spmv_tiled_kernel<TD, TX, false>;
  kernel<<<(n + tn - 1) / tn, threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TD*>(data), static_cast<const TX*>(x),
      static_cast<TX*>(y), n, ghost, tn, offs);
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

// The tiled route: the same four forms, with the wrapper's tile of `tn`
// rows.
extern "C" int dia_spmv_tiled_f32(const void* data, const void* x, void* y,
                                  int k, int n, int ghost, const int* offsets,
                                  int tn, void* stream) {
  return launch_tiled<float, float>(data, x, y, k, n, ghost, offsets, tn,
                                    stream);
}

extern "C" int dia_spmv_tiled_f64(const void* data, const void* x, void* y,
                                  int k, int n, int ghost, const int* offsets,
                                  int tn, void* stream) {
  return launch_tiled<double, double>(data, x, y, k, n, ghost, offsets, tn,
                                      stream);
}

extern "C" int dia_spmv_tiled_bf16_f32(const void* data, const void* x,
                                       void* y, int k, int n, int ghost,
                                       const int* offsets, int tn,
                                       void* stream) {
  return launch_tiled<__nv_bfloat16, float>(data, x, y, k, n, ghost, offsets,
                                            tn, stream);
}

extern "C" int dia_spmv_tiled_bf16_f64(const void* data, const void* x,
                                       void* y, int k, int n, int ghost,
                                       const int* offsets, int tn,
                                       void* stream) {
  return launch_tiled<__nv_bfloat16, double>(data, x, y, k, n, ghost,
                                             offsets, tn, stream);
}
