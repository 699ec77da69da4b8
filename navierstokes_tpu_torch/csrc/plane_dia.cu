// Component-plane banded SpMV (kernel K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel navierstokes_tpu/ops/plane_dia.py::_plane_kernel
// (driven there by spmv_planes_pallas / spmv_plane_pallas).  It computes
//
//     y_a[i] = sum_{iD, b}  data[a, iD*n_in + b, i] * x_b[i + D[iD]]
//
// for a < n_out, b < n_in, over the N_D <= 128 node offsets D, with the
// terms in `plane_terms` order (j = iD*n_in + b).  Layout: data (n_out,
// n_in*N_D, nbp), x (n_in, nbp) and y (n_out, nbp), all plane-major and
// contiguous.
//
// What bounds it: bytes.  Each operator value is read once and used for one
// multiply-add, 2 flops per 4 bytes in f32: 0.5 flop per operator byte, far
// below the card's ridge point.  The design only has to stream the operator
// at full bandwidth, and what decides that is the bytes each SM keeps in
// flight (band_ring.cuh).  Two routes compute the same function with the 60
// terms of a row summed in the same order (iD outer, b inner), in a fixed
// order and without atomics, so two runs give the same bits:
//
//   * the tiled route (plane_spmv_tiled_*).  A block owns a tile of `tn`
//     node rows (up to 512) and all n_out output planes, one consumer
//     thread per row.  `tn` is chosen by the wrapper so that the tiles
//     fill the card in whole waves of one block per SM (29,440 rows on 132
//     SMs: 132 tiles of 224 rows); a larger matrix is walked by persistent
//     blocks, tile after tile, with the ring running on across tiles.  The
//     tile's x window is copied to shared memory once, one segment per
//     cluster of node offsets (band_ring.cuh): for a 3-D mesh's 15 offsets
//     in 3 clusters and their 65-offset sumset in 5, the tile's rows and
//     each cluster's span, not the band's width.  The wrapper's plan names
//     the clusters; the launcher only checks that every offset lies in one
//     and that ring and window fit.  Exact zeros stand outside
//     [0, nbp): this replaces a mask per load, and keeps the rule that DIA
//     data may be nonzero where i + D leaves the matrix.
//     The operator goes through the ring: one stage is the n_out*n_in row
//     segments of G consecutive node offsets, G chosen by the plan so that
//     a stage is about 16 KB (one offset of a 4x4 tile of 224 rows, 8
//     offsets of a 1x1 tile of 512); a plan of one offset a stage runs an
//     instance compiled for G = 1.  The segments come by a bulk copy each,
//     or, on tiles of short rows (a shard's 64 rows: 256-byte segments,
//     where the copy engine's cost per copy and not the bytes had set the
//     time), by one tensor copy per node offset: the plan picks the copy
//     (ops/band_ring.py tensor_copies), the launcher encodes the tensor map.
//   * the row-per-thread route (plane_spmv_rows_*), the port's first kernel:
//     one thread per node row, the n_out accumulators in registers, loads of
//     data[a, j, i] coalesced along i, x masked per load.  It has about 7
//     warps per SM and four 4-byte loads per thread in flight, which is what
//     bounds it; it takes any nbp and any band width, so it serves the
//     shapes the tiled route does not take (a window that does not fit
//     shared memory, rows that do not start on 16 bytes).
//
// The ghost-row form (`ghost` = g > 0; the TPU kernel's x_prehalo=True, run
// per shard by the distributed solver, parallel/partitioned.py): each plane
// of x holds nbp + 2g values, x_b[g + j] for j in [-g, nbp + g), the g
// ghost rows on either side filled by the halo exchange from the
// neighbouring shards (zeros beyond the matrix).  With g >= max|D| every
// i + D lands in that range: the rows route drops its mask, and the tiled
// route's window takes [-g, nbp + g) as the source's valid range and
// nbp + 2g as its plane stride (g a multiple of 16 bytes, so that the
// window's bulk copies stay aligned).  The terms are summed in the same
// order as without ghosts, so a shard's rows equal the rows of one launch
// on the whole vector bit for bit.  g = 0 is the masked form unchanged.
//
// Rows nb <= i < nbp are padding and are written as exact zeros by both.
// Accumulation is in float for f32 data and in double for f64 data
// (promote(dtype, f32), as in the TPU kernel).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "band_ring.cuh"

namespace {

using band_ring::Accum;

// Node offsets a launch takes: the 15 of the 4x4 operator, and the 65 of the
// Schur complement S_hat, whose band is the sumset of the node offsets.
constexpr int kMaxOffsets = 128;
constexpr int kMaxPlanes = 4;
constexpr int kThreads = 128;   // row-per-thread route
constexpr int kMaxTile = 512;   // tiled route: rows (= consumer threads)

struct NodeOffsets {
  int n;
  int d[kMaxOffsets];
};

// The tiled route's view of the offsets: x_b[i0 + r + D[t]] of the tile at
// i0 is plane b of its x window at pos[t] + r, in the segment of D[t]'s
// cluster.
struct TiledLayout {
  int n;
  int pos[kMaxOffsets];
  band_ring::Window win;
};
static_assert(sizeof(band_ring::Barriers) + sizeof(band_ring::Window) <=
                  band_ring::kHeaderBytes,
              "the header holds the barriers and the window's segments");

// ---------------------------------------------------------------- rows route

// kGhost: the ghost-row form, compiled apart so that the masked form's code
// is the one it always was.
template <typename T, int NOUT, bool kGhost>
__global__ void __launch_bounds__(kThreads)
plane_spmv_rows_kernel(const T* __restrict__ data, const T* __restrict__ x,
                       T* __restrict__ y, int n_in, int nb, int nbp,
                       int ghost, NodeOffsets offs) {
  using A = typename Accum<T>::type;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nbp) return;
  if (i >= nb) {
#pragma unroll
    for (int a = 0; a < NOUT; ++a) y[(size_t)a * nbp + i] = T(0);
    return;
  }
  const size_t plane_stride = (size_t)n_in * offs.n * nbp;  // between a's
  const size_t x_stride = kGhost ? (size_t)nbp + 2 * ghost : (size_t)nbp;
  const int x0 = kGhost ? ghost : 0;  // x_b[0] of plane b at x[b*x_stride+x0]
  A acc[NOUT];
#pragma unroll
  for (int a = 0; a < NOUT; ++a) acc[a] = A(0);

  const T* col = data + i;  // data[0, j, i], advanced by nbp per term j
  for (int t = 0; t < offs.n; ++t) {
    const int src = i + offs.d[t];
    const bool inside = kGhost || (src >= 0 && src < nbp);
    for (int b = 0; b < n_in; ++b, col += nbp) {
      const A xv = inside ? A(x[(size_t)b * x_stride + x0 + src]) : A(0);
#pragma unroll
      for (int a = 0; a < NOUT; ++a) {
        acc[a] += A(col[a * plane_stride]) * xv;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NOUT; ++a) y[(size_t)a * nbp + i] = T(acc[a]);
}

bool bad_shape(int n_out, int n_in, int n_d, int nb, int nbp, int ghost,
               const int* offsets) {
  if (n_out < 1 || n_out > kMaxPlanes || n_in < 1 || n_in > kMaxPlanes ||
      n_d < 1 || n_d > kMaxOffsets || nb < 0 || nb > nbp || nbp < 1 ||
      ghost < 0 || offsets == nullptr) {
    return true;
  }
  for (int t = 0; t < n_d && ghost > 0; ++t) {
    if (offsets[t] > ghost || offsets[t] < -ghost) return true;
  }
  return false;
}

NodeOffsets pack(const int* offsets, int n_d) {
  NodeOffsets offs;
  offs.n = n_d;
  for (int t = 0; t < kMaxOffsets; ++t) offs.d[t] = t < n_d ? offsets[t] : 0;
  return offs;
}

template <typename T, bool kGhost>
void rows_nout(int n_out, dim3 grid, dim3 block, cudaStream_t s, const T* d,
               const T* xv, T* yv, int n_in, int nb, int nbp, int ghost,
               const NodeOffsets& offs) {
  switch (n_out) {
    case 1:
      plane_spmv_rows_kernel<T, 1, kGhost><<<grid, block, 0, s>>>(
          d, xv, yv, n_in, nb, nbp, ghost, offs);
      break;
    case 2:
      plane_spmv_rows_kernel<T, 2, kGhost><<<grid, block, 0, s>>>(
          d, xv, yv, n_in, nb, nbp, ghost, offs);
      break;
    case 3:
      plane_spmv_rows_kernel<T, 3, kGhost><<<grid, block, 0, s>>>(
          d, xv, yv, n_in, nb, nbp, ghost, offs);
      break;
    default:
      plane_spmv_rows_kernel<T, 4, kGhost><<<grid, block, 0, s>>>(
          d, xv, yv, n_in, nb, nbp, ghost, offs);
      break;
  }
}

template <typename T>
int launch_rows(const void* data, const void* x, void* y, int n_out, int n_in,
                int n_d, int nb, int nbp, int ghost, const int* offsets,
                void* stream) {
  if (bad_shape(n_out, n_in, n_d, nb, nbp, ghost, offsets)) {
    return (int)cudaErrorInvalidValue;
  }
  const NodeOffsets offs = pack(offsets, n_d);
  const dim3 grid((nbp + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* d = static_cast<const T*>(data);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  if (ghost > 0) {
    rows_nout<T, true>(n_out, grid, block, s, d, xv, yv, n_in, nb, nbp, ghost,
                       offs);
  } else {
    rows_nout<T, false>(n_out, grid, block, s, d, xv, yv, n_in, nb, nbp, 0,
                        offs);
  }
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- tiled route

// Shared memory: [mbarriers, the window's segments: kHeaderBytes][ring:
// stages slots of G node offsets' NOUT*NIN segments of tn values][x
// windows: one, or two where the block walks several tiles, of NIN planes
// of win.plane values].  Threads:
// tn consumers (row i0 + r each), then the producer warp.  Slot segment
// (k * NOUT + a) * NIN + b holds data[a, (d0 + k) * NIN + b, i0:i0 + tn].
// With `tensor`, node offset d0 + k's segments are the box (tn, NIN, NOUT)
// of `op`, the map of data as the 3-D tensor (nbp, NIN * N_D, NOUT)
// (innermost first), at (i0, (d0 + k) * NIN, 0): it lands as [a][b][row],
// that same layout, with zeros for the rows past nbp.
template <typename T, int NOUT, int NIN, int kGroup>
__global__ void __launch_bounds__(kMaxTile + band_ring::kProducerThreads, 1)
plane_spmv_tiled_kernel(const __grid_constant__ CUtensorMap op,
                        const T* __restrict__ data, const T* __restrict__ x,
                        T* __restrict__ y, int nb, int nbp, int ghost, int tn,
                        int group, int stages, bool tensor, TiledLayout lay) {
  using A = typename Accum<T>::type;
  constexpr int kSegs = NOUT * NIN;   // row segments of one node offset
  extern __shared__ __align__(128) unsigned char smem[];
  auto* bars = reinterpret_cast<band_ring::Barriers*>(smem);
  // The producer walks the window's segments at every tile: a copy in
  // shared memory.  The consumers read lay.pos[d] from the parameter, a
  // uniform constant-cache load.
  auto* win_s = reinterpret_cast<band_ring::Window*>(
      smem + sizeof(band_ring::Barriers));
  T* ring = reinterpret_cast<T*>(smem + band_ring::kHeaderBytes);
  if (kGroup) group = kGroup;
  const int slot_values = group * kSegs * tn;
  const int plane = lay.win.plane;
  T* xw = ring + (size_t)stages * slot_values;

  const int r = threadIdx.x;
  const int n_tiles = (nbp + tn - 1) / tn;
  const int my_tiles =
      (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (r < band_ring::kMaxClusters) {
    win_s->lo[r] = lay.win.lo[r];
    win_s->w[r] = lay.win.w[r];
    win_s->at[r] = lay.win.at[r];
  }
  if (r == 0) {
    win_s->n = lay.win.n;
    win_s->plane = plane;
    band_ring::init_barriers(bars, tn / 32);
  }
  __syncthreads();
  const int n_d = lay.n;

  if (r >= tn) {
    // Producer warp: its lanes share the copies of a stage.
    const int lane = r - tn;
    const size_t nt = (size_t)NIN * n_d;
    // Segment c = (k * NOUT + a) * NIN + b of a slot is data[a, (d0 + k) *
    // NIN + b, i0:] of the stage at node offset d0; a lane copies c = lane,
    // lane + 32, ...  Its first lies at the same distance from the stage's
    // first row in every stage, worked out here once: the producer runs
    // ahead of the consumers only as fast as it starts copies.
    const size_t first =
        ((size_t)((lane / NIN) % NOUT) * nt +
         (size_t)(lane / kSegs) * NIN + lane % NIN) * nbp;
    if (tensor && lane == 0) {
      band_ring::prefetch_tensor_map(&op);
      // Tensor copies land on kBoxAlign bytes only if the block's shared
      // memory starts on them (the slots then do: tn is whole warps).
      if (band_ring::smem_addr(ring) % band_ring::kBoxAlign != 0) __trap();
    }
    band_ring::Cursor cur{0, 1};
    for (int m = 0; m < my_tiles; ++m) {
      const int i0 = ((int)blockIdx.x + m * (int)gridDim.x) * tn;
      // A bulk copy brings the rows up to nbp; a tensor copy its whole box,
      // the rows past nbp as zeros, and counts all of them.
      const uint32_t bytes =
          (uint32_t)((tensor ? tn : min(tn, nbp - i0)) * sizeof(T));
      const band_ring::WindowUse win(m, my_tiles);
      band_ring::wait(bars->window_empty + win.buffer, win.parity ^ 1);
      band_ring::load_window(xw + win.buffer * NIN * plane, x + ghost, NIN,
                             nbp + 2 * ghost, -ghost, nbp + ghost, i0,
                             *win_s, bars->window_full + win.buffer);
      for (int d0 = 0; d0 < n_d; d0 += group) {
        const int g = kGroup ? kGroup : min(group, n_d - d0);
        const int copies = g * kSegs;   // row segments of the stage
        band_ring::wait(bars->empty + cur.slot, cur.parity);
        uint64_t* full = bars->full + cur.slot;
        if (lane == 0) band_ring::expect_bytes(full, copies * bytes);
        __syncwarp();
        T* slot = ring + (size_t)cur.slot * slot_values;
        if (tensor) {
          // lane k: node offset d0 + k's box
          for (int k = lane; k < g; k += 32) {
            band_ring::tensor_load_3d(slot + (size_t)k * kSegs * tn, &op, i0,
                                      (d0 + k) * NIN, 0, full);
          }
        } else {
          const T* src = data + (size_t)d0 * NIN * nbp + i0;
          if (lane < copies) {
            band_ring::bulk_load(slot + (size_t)lane * tn, src + first,
                                 bytes, full);
          }
          for (int c = lane + 32; c < copies; c += 32) {
            const int k = c / kSegs, a = (c / NIN) % NOUT, b = c % NIN;
            band_ring::bulk_load(
                slot + (size_t)c * tn,
                src + ((size_t)a * nt + (size_t)k * NIN + b) * nbp, bytes,
                full);
          }
        }
        cur.advance(stages);
      }
    }
    return;
  }

  band_ring::Cursor cur{0, 0};
  for (int m = 0; m < my_tiles; ++m) {
    const int i = ((int)blockIdx.x + m * (int)gridDim.x) * tn + r;
    A acc[NOUT];
#pragma unroll
    for (int a = 0; a < NOUT; ++a) acc[a] = A(0);
    const band_ring::WindowUse win(m, my_tiles);
    band_ring::wait(bars->window_full + win.buffer, win.parity);
    const T* xr = xw + win.buffer * NIN * plane + r;
    for (int d0 = 0; d0 < n_d; d0 += group) {
      const int g = kGroup ? kGroup : min(group, n_d - d0);
      band_ring::wait(bars->full + cur.slot, cur.parity);
      const T* seg = ring + (size_t)cur.slot * slot_values + r;
      for (int k = 0; k < g; ++k, seg += kSegs * tn) {
        const T* xc = xr + lay.pos[d0 + k];
#pragma unroll
        for (int b = 0; b < NIN; ++b) {
          const A xv = A(xc[b * plane]);
#pragma unroll
          for (int a = 0; a < NOUT; ++a) {
            acc[a] += A(seg[(a * NIN + b) * tn]) * xv;
          }
        }
      }
      band_ring::release(bars->empty + cur.slot);
      cur.advance(stages);
    }
    band_ring::release(bars->window_empty + win.buffer);
    if (i < nbp) {
#pragma unroll
      for (int a = 0; a < NOUT; ++a) {
        y[(size_t)a * nbp + i] = i < nb ? T(acc[a]) : T(0);
      }
    }
  }
}

// The x window's segments, from the wrapper's clusters (ops/band_ring.py
// window_clusters: `n_c` pairs lo, hi of node offsets, both multiples of 16
// bytes): segment c spans its cluster and the tile's tn rows.  False where
// the clusters are not that, or an offset lies in none of them.
bool window_layout(const int* offsets, int n_d, const int* clusters, int n_c,
                   int tn, int unit, TiledLayout* lay) {
  if (clusters == nullptr || n_c < 1 || n_c > band_ring::kMaxClusters) {
    return false;
  }
  band_ring::Window& win = lay->win;
  win.n = n_c;
  long long plane = 0;
  for (int c = 0; c < n_c; ++c) {
    const int lo = clusters[2 * c], hi = clusters[2 * c + 1];
    if (lo > hi || lo % unit != 0 || hi % unit != 0) return false;
    win.lo[c] = lo;
    win.w[c] = tn + hi - lo;
    win.at[c] = (int)plane;
    plane += win.w[c];
    if (plane > band_ring::kSmemLimit) return false;
  }
  win.plane = (int)plane;
  lay->n = n_d;
  for (int t = 0; t < n_d; ++t) {
    int c = 0;
    while (c < n_c && (offsets[t] < clusters[2 * c] ||
                       offsets[t] > clusters[2 * c + 1])) {
      ++c;
    }
    if (c == n_c) return false;
    lay->pos[t] = win.at[c] + offsets[t] - win.lo[c];
  }
  return true;
}

// What a tiled launch needs beside the tensors: `op` is the operator's
// tensor map where the plan copies by tensor, else unused.
struct TiledLaunch {
  int nb, nbp, ghost, tn, group, stages, grid;
  bool tensor;
  size_t smem;
  cudaStream_t stream;
  CUtensorMap op;
};

// cuTensorMapEncodeTiled, a function of libcuda, reached through the
// runtime's entry point query so that this library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Returned for a tensor map that does not encode: kEncodeError + the
// CUresult (ops/plane_dia.py ENCODE_ERROR).
constexpr int kEncodeError = 10000;

// The map of data (n_out, nt = n_in * N_D, nbp) as a 3-D tensor, innermost
// first, in boxes of (tn, n_in, n_out) values: 0 where it encodes.  The
// L2 promotion made no difference in turns (none, 128 B, 256 B; PERF.md).
template <typename T>
int encode_operator(CUtensorMap* map, const void* data, int n_out, int nt,
                    int nbp, int tn, int n_in) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)nbp, (cuuint64_t)nt,
                              (cuuint64_t)n_out};
  const cuuint64_t strides[2] = {(cuuint64_t)nbp * sizeof(T),
                                 (cuuint64_t)nt * nbp * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)tn, (cuuint32_t)n_in,
                             (cuuint32_t)n_out};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = encode(
      map,
      sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(data), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + (int)rc;
}

template <typename T, int NOUT, int NIN, int kGroup>
int launch_tiled_group(const T* data, const T* x, T* y, const TiledLaunch& l,
                       const TiledLayout& lay) {
  auto kernel = plane_spmv_tiled_kernel<T, NOUT, NIN, kGroup>;
  static bool allowed[band_ring::kDevices] = {};   // of this instantiation
  const cudaError_t rc = band_ring::allow_full_smem(kernel, allowed);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<l.grid, l.tn + band_ring::kProducerThreads, l.smem, l.stream>>>(
      l.op, data, x, y, l.nb, l.nbp, l.ghost, l.tn, l.group, l.stages,
      l.tensor, lay);
  return (int)cudaGetLastError();
}

// A plan of one node offset a stage (the 4x4 and 3x3 forms of 224 rows
// and more) runs an instance compiled for it: its stage loop has no inner
// loop over offsets.
template <typename T, int NOUT, int NIN>
int launch_tiled_form(const T* data, const T* x, T* y, const TiledLaunch& l,
                      const TiledLayout& lay) {
  if (l.group == 1) {
    return launch_tiled_group<T, NOUT, NIN, 1>(data, x, y, l, lay);
  }
  return launch_tiled_group<T, NOUT, NIN, 0>(data, x, y, l, lay);
}

template <typename T, int NOUT>
int launch_tiled_nout(int n_in, const T* data, const T* x, T* y,
                      const TiledLaunch& l, const TiledLayout& lay) {
  switch (n_in) {
    case 1: return launch_tiled_form<T, NOUT, 1>(data, x, y, l, lay);
    case 2: return launch_tiled_form<T, NOUT, 2>(data, x, y, l, lay);
    case 3: return launch_tiled_form<T, NOUT, 3>(data, x, y, l, lay);
    default: return launch_tiled_form<T, NOUT, 4>(data, x, y, l, lay);
  }
}

// The clusters, `tn`, `group`, `stages`, `grid` and `tensor` are the
// wrapper's tile plan (ops/plane_dia.py tile_plan); what the plan must
// satisfy is checked again here.
template <typename T>
int launch_tiled(const void* data, const void* x, void* y, int n_out, int n_in,
                 int n_d, int nb, int nbp, int ghost, const int* offsets,
                 int n_c, const int* clusters, int tn, int group, int stages,
                 int grid, int tensor, void* stream) {
  if (bad_shape(n_out, n_in, n_d, nb, nbp, ghost, offsets) || tn < 32 ||
      tn > kMaxTile || tn % 32 != 0 || group < 1 || group > n_d ||
      (tensor && tn > band_ring::kMaxBox) ||
      stages < 1 || stages > band_ring::kMaxStages || grid < 1 ||
      grid > (nbp + tn - 1) / tn ||
      ((size_t)nbp * sizeof(T)) % 16 != 0 ||
      ((size_t)ghost * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  TiledLayout lay;
  if (!window_layout(offsets, n_d, clusters, n_c, tn,
                     band_ring::align_values<T>(), &lay)) {
    return (int)cudaErrorInvalidValue;
  }
  const int windows = band_ring::window_buffers((nbp + tn - 1) / tn, grid);
  const long long smem =
      band_ring::kHeaderBytes +
      ((long long)stages * group * n_out * n_in * tn +
       (long long)windows * n_in * lay.win.plane) *
          (long long)sizeof(T);
  if (smem > band_ring::kSmemLimit) return (int)cudaErrorInvalidValue;

  TiledLaunch l{nb,     nbp,    ghost, tn,
                group,  stages, grid,  tensor != 0,
                (size_t)smem, static_cast<cudaStream_t>(stream), {}};
  if (l.tensor) {
    const int encoded =
        encode_operator<T>(&l.op, data, n_out, n_in * n_d, nbp, tn, n_in);
    if (encoded != 0) return encoded;
  }
  const T* d = static_cast<const T*>(data);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  switch (n_out) {
    case 1: return launch_tiled_nout<T, 1>(n_in, d, xv, yv, l, lay);
    case 2: return launch_tiled_nout<T, 2>(n_in, d, xv, yv, l, lay);
    case 3: return launch_tiled_nout<T, 3>(n_in, d, xv, yv, l, lay);
    default: return launch_tiled_nout<T, 4>(n_in, d, xv, yv, l, lay);
  }
}

}  // namespace

// Each plane of x holds nbp + 2 * ghost values (ghost = 0: nbp, the masked
// form); x points at the first plane's first value.
extern "C" int plane_spmv_rows_f32(const void* data, const void* x, void* y,
                                   int n_out, int n_in, int n_d, int nb,
                                   int nbp, int ghost, const int* offsets,
                                   void* stream) {
  return launch_rows<float>(data, x, y, n_out, n_in, n_d, nb, nbp, ghost,
                            offsets, stream);
}

extern "C" int plane_spmv_rows_f64(const void* data, const void* x, void* y,
                                   int n_out, int n_in, int n_d, int nb,
                                   int nbp, int ghost, const int* offsets,
                                   void* stream) {
  return launch_rows<double>(data, x, y, n_out, n_in, n_d, nb, nbp, ghost,
                             offsets, stream);
}

extern "C" int plane_spmv_tiled_f32(const void* data, const void* x, void* y,
                                    int n_out, int n_in, int n_d, int nb,
                                    int nbp, int ghost, const int* offsets,
                                    int n_c, const int* clusters, int tn,
                                    int group, int stages, int grid,
                                    int tensor, void* stream) {
  return launch_tiled<float>(data, x, y, n_out, n_in, n_d, nb, nbp, ghost,
                             offsets, n_c, clusters, tn, group, stages,
                             grid, tensor, stream);
}

extern "C" int plane_spmv_tiled_f64(const void* data, const void* x, void* y,
                                    int n_out, int n_in, int n_d, int nb,
                                    int nbp, int ghost, const int* offsets,
                                    int n_c, const int* clusters, int tn,
                                    int group, int stages, int grid,
                                    int tensor, void* stream) {
  return launch_tiled<double>(data, x, y, n_out, n_in, n_d, nb, nbp, ghost,
                              offsets, n_c, clusters, tn, group, stages,
                              grid, tensor, stream);
}
