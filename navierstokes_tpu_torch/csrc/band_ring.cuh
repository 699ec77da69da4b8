// The shared-memory ring that kernel K1's tiled route (plane_dia.cu) uses to
// stream a banded operator on Hopper (sm_90a).
//
// A banded SpMV reads every operator value once and does one multiply-add
// with it, so it is bound by bytes, and what sets its pace is how many bytes
// of the operator each SM has in flight: at ~0.6-0.8 us of memory latency
// the card needs 15-20 KB per SM to keep 3.35 TB/s busy.  A thread that
// loads its own values has a handful of 4-byte loads in flight.  Here the
// lanes of a producer warp ask the copy engine for whole row segments
// instead (`cp.async.bulk`, the 1-D bulk copy of the Tensor Memory
// Accelerator).  A stage of the ring is sized in bytes, not in offsets: it
// holds the row segments of G consecutive node offsets of one row tile
// (n_out * n_in segments each), G chosen by the wrapper's plan so that a
// stage is about 16 KB whatever the form, from one offset of a 4x4
// operator to 8 offsets of a 1x1 one; `stages` of them are in flight per
// SM while the consumer warps multiply from shared memory, G * n_out * n_in
// multiply-adds per row for each barrier round trip.  Each stage completes
// on an `mbarrier` that counts the bytes that have landed.
//
// The x window of a row tile is made of segments, one per cluster of node
// offsets (a new cluster wherever the gap to the next offset exceeds the
// tile: a segment of its own costs the tile's rows again, a contiguous one
// the gap; at most kMaxClusters, split at the widest gaps), so that a band
// whose offsets sit in a few tight clusters far apart (the 3 of a 3-D
// mesh's 15 node offsets, the 5 of their sumset) loads the tile's rows and
// each cluster's span, not the band's whole width (the wrapper's plan,
// ops/band_ring.py window_clusters, names the clusters).  One bulk copy
// per segment and plane, all on one barrier; the part of a segment
// outside the matrix is written as exact zeros by 16-byte stores.
// Segments start and end on 16 bytes: the plan rounds a cluster's
// smallest offset down and its largest up.
//
// Roles.  The last warp of the block is the producer, the others consume.
// The producer's lanes start a stage's copies side by side (one thread
// starting 16 copies in turn spends ~50 cycles on each, which alone held a
// 4x4 plane tile to half its rate).  Every slot has a "full" barrier (the
// producer's expect_tx arrival and the bytes) and an "empty" barrier (one
// arrival per consumer warp): the producer refills a slot when every
// consumer warp has released it, and the consumer warps never wait for one
// another, so there is no block-wide barrier in the loop.  The x window has
// the same pair.  Barriers start in phase 0; the producer's cursor starts
// at parity 1, so its first pass over the ring does not wait.  Every wait
// is bounded: a copy that never completes traps (and shows as a launch
// error in the wrapper) instead of hanging the card.
//
// A block that walks several tiles has two window buffers, so that the
// producer, which runs up to `stages` stages ahead of the consumers, can
// ask for the next tile's window while the consumers still read this one's,
// and the ring runs on across the tile change.
//
// Bulk copies need 16-byte aligned source, destination and size; the
// wrapper routes operators whose rows do not start on such a boundary to
// the row-per-thread kernel.
//
// What bounds the ring itself, measured on an H100 (PERF.md): the copy
// engine of an SM spends ~37 ns on a bulk copy of up to ~1 KB whatever its
// size, and moves ~30 GB/s on larger ones, which over 132 SMs is the rate
// of the L2; so the plan prefers tiles of up to 512 rows (2 KB segments in
// f32).  The same ring built from per-thread `cp.async` 16-byte copies,
// with one __syncthreads() per stage, was slower at every shape tried.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace band_ring {

constexpr int kMaxStages = 8;          // slots of the ring at most
constexpr int kMaxClusters = 8;        // x window segments of a tile
constexpr int kProducerThreads = 32;   // one warp; its lanes start the copies
constexpr int kHeaderBytes = 512;      // mbarriers, window layout: ring follows
constexpr int kSmemLimit = 232448;     // dynamic shared memory of one block
constexpr long long kWaitCycles = 4000000000LL;  // ~2 s: then trap

template <typename T>
struct Accum {
  using type = float;
};
template <>
struct Accum<double> {
  using type = double;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The header's barriers: full[kMaxStages], empty[kMaxStages], then the
// full and empty of the two x window buffers.
struct Barriers {
  uint64_t full[kMaxStages];
  uint64_t empty[kMaxStages];
  uint64_t window_full[2];
  uint64_t window_empty[2];
};
static_assert(sizeof(Barriers) <= kHeaderBytes, "header holds the barriers");

__device__ __forceinline__ void init_barrier(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// One thread, before anyone waits.  A full barrier takes the producer's one
// arrival per phase, an empty barrier one arrival per consumer warp.
__device__ __forceinline__ void init_barriers(Barriers* bars,
                                              int consumer_warps) {
  for (int s = 0; s < kMaxStages; ++s) {
    init_barrier(bars->full + s, 1);
    init_barrier(bars->empty + s, consumer_warps);
  }
  for (int s = 0; s < 2; ++s) {
    init_barrier(bars->window_full + s, 1);
    init_barrier(bars->window_empty + s, consumer_warps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// A consumer warp is done with what the barrier guards: all lanes call it,
// lane 0 arrives after the warp's reads.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
  }
}

// The producer's arrival for this phase, announcing the bytes to come.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// The bytes to come in this phase, announced without arriving: the
// producer arrives later (`arrive`), after stores of its own.
__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival of the calling thread, publishing its prior stores.
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One bulk copy global -> shared; its bytes count on `bar` as they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the barrier has completed its phase of parity `parity`.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// The x window of a row tile: `n` segments, one per cluster of offsets.
// Segment c covers x rows [i0 + lo[c], i0 + lo[c] + w[c]) of the tile whose
// first row is i0, and sits at [at[c], at[c] + w[c]) of each plane of the
// buffer; a plane of the buffer holds `plane` values, the sum of the w[c].
// lo, w, at and plane are multiples of 16 bytes.
struct Window {
  int n;
  int lo[kMaxClusters];
  int w[kMaxClusters];
  int at[kMaxClusters];
  int plane;
};

// The producer warp: fill the x window of the tile at i0.  xw holds
// `planes` planes of win.plane values; segment c of plane b,
// xw[b * win.plane + win.at[c] + k], is x[b * stride + i0 + win.lo[c] + k].
// Lane (c, b) owns segment c of plane b: the part inside the source's
// valid range [lo, hi) comes by one bulk copy, announced on `bar` with the
// others' before any starts; the rest, only in the tiles at the ends of the
// range, is written as exact zeros, 16 bytes a store, by the whole warp
// while the copies are in flight, and the warp's arrival on `bar` then
// publishes them.  The producer does this ahead of every stage of the
// tile, and the slowest block sets the launch's time, so the zero stores
// run on bounds held in registers: re-read from `win` in shared memory at
// every store (a store to shared memory may alias it), they held the two
// end tiles of a launch back long enough to slow the whole launch.
// A plane of n rows has stride n and range [0, n); with g ghost rows on
// either side (x pointing at row 0 of the first plane), stride n + 2g and
// range [-g, n + g).  `stride`, `lo`, `hi`, i0 and xw's segments lie on 16
// bytes; planes * win.n is at most 32.
template <typename T>
__device__ __forceinline__ void load_window(T* xw, const T* x, int planes,
                                            int stride, int lo, int hi,
                                            int i0, const Window& win,
                                            uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < planes * win.n;
  const int c = mine ? lane / planes : 0, b = lane % planes;
  const int base = i0 + win.lo[c], w = win.w[c];
  const int at = b * win.plane + win.at[c];     // the segment in xw
  const int g0 = min(max(lo, base), base + w);
  const int g1 = max(min(hi, base + w), g0);
  const uint32_t bytes = mine ? (uint32_t)((g1 - g0) * sizeof(T)) : 0u;
  const uint32_t total = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) expect_tx(bar, total);
  __syncwarp();
  if (bytes) {
    bulk_load(xw + at + (g0 - base), x + ((ptrdiff_t)b * stride + g0), bytes,
              bar);
  }
  constexpr int kUnit = 16 / (int)sizeof(T);
  unsigned edges =
      __ballot_sync(0xffffffffu, mine && (g0 > base || g1 < base + w));
  const bool any = edges != 0;
  while (edges) {
    const int owner = __ffs(edges) - 1;
    edges &= edges - 1;
    uint4* seg = reinterpret_cast<uint4*>(
        xw + __shfl_sync(0xffffffffu, at, owner));
    const int z0 = __shfl_sync(0xffffffffu, g0 - base, owner) / kUnit;
    const int z1 = __shfl_sync(0xffffffffu, g1 - base, owner) / kUnit;
    const int zw = __shfl_sync(0xffffffffu, w, owner) / kUnit;
    for (int k = lane; k < z0; k += 32) seg[k] = make_uint4(0, 0, 0, 0);
    for (int k = z1 + lane; k < zw; k += 32) seg[k] = make_uint4(0, 0, 0, 0);
  }
  if (any) __threadfence_block();
  __syncwarp();
  if (lane == 0) arrive(bar);
}

// 16-byte alignment of window bounds, in values of T.
template <typename T>
constexpr int align_values() { return 16 / (int)sizeof(T); }
inline int round_down(int v, int a) {
  return (v >= 0 ? v / a : -((-v + a - 1) / a)) * a;
}
inline int round_up(int v, int a) { return -round_down(-v, a); }

// Host: let `kernel` ask for up to kSmemLimit of dynamic shared memory.
// Asked once per kernel and device: the call costs host time on every
// launch of a solver loop that is bound by its launches.  `allowed` is the
// caller's own flags for this kernel, one per device.
constexpr int kDevices = 64;

template <typename Kernel>
cudaError_t allow_full_smem(Kernel kernel, bool (&allowed)[kDevices]) {
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return rc;
  if (device < kDevices && allowed[device]) return cudaSuccess;
  rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (rc == cudaSuccess && device < kDevices) allowed[device] = true;
  return rc;
}

// Window buffers of a launch: two where a block walks more than one tile.
inline int window_buffers(int n_tiles, int grid) {
  return n_tiles > grid ? 2 : 1;
}

// Which window buffer tile number `m` of a block uses, and the parity of
// that use: buffers alternate where there are two.
struct WindowUse {
  int buffer;
  uint32_t parity;
  __device__ __forceinline__ WindowUse(int m, int my_tiles) {
    buffer = my_tiles > 1 ? (m & 1) : 0;
    parity = (my_tiles > 1 ? (m >> 1) : m) & 1;
  }
};

// Position in the ring: slot and the parity to wait with.  A consumer
// starts at parity 0 (wait for the first fill), the producer at parity 1
// (the first pass finds every slot free).
struct Cursor {
  int slot;
  uint32_t parity;
  __device__ __forceinline__ void advance(int stages) {
    if (++slot == stages) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

}  // namespace band_ring
