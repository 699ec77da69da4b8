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
//     node rows and all n_out output planes, one consumer thread per row.
//     `tn` is chosen by the wrapper so that the tiles fill the card in whole
//     waves of one block per SM (29,440 rows on 132 SMs: 132 tiles of 224
//     rows); a larger matrix is walked by persistent blocks, tile after
//     tile, with the ring running on across tiles.  The tile's x window
//     x_b[i0 + Dmin .. i0 + tn + Dmax) is copied to shared memory once (one
//     bulk copy per plane), with exact zeros outside [0, nbp): this replaces
//     a mask per load, and keeps the rule that DIA data may be nonzero where
//     i + D leaves the matrix.
//     The operator goes through the ring: one stage is the n_out*n_in row
//     segments of one node offset (16 x 896 B at 4x4 f32), each a bulk copy.
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
constexpr int kMaxTile = 256;   // tiled route: rows (= consumer threads)

struct NodeOffsets {
  int n;
  int d[kMaxOffsets];
};

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

// Shared memory: [mbarriers, kHeaderBytes][ring: stages slots of
// NOUT*NIN segments of tn values][x windows: one, or two where the block
// walks several tiles, of NIN planes of w values].  Threads: tn consumers
// (row i0 + r each), then the producer warp.
template <typename T, int NOUT, int NIN>
__global__ void __launch_bounds__(kMaxTile + band_ring::kProducerThreads, 1)
plane_spmv_tiled_kernel(const T* __restrict__ data, const T* __restrict__ x,
                        T* __restrict__ y, int nb, int nbp, int ghost, int tn,
                        int stages, int dlo, int w, NodeOffsets offs) {
  using A = typename Accum<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* bars = reinterpret_cast<band_ring::Barriers*>(smem);
  T* ring = reinterpret_cast<T*>(smem + band_ring::kHeaderBytes);
  const int slot_values = NOUT * NIN * tn;
  T* xw = ring + (size_t)stages * slot_values;

  const int r = threadIdx.x;
  const int n_tiles = (nbp + tn - 1) / tn;
  const int my_tiles =
      (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (r == 0) band_ring::init_barriers(bars, tn / 32);
  __syncthreads();

  if (r >= tn) {
    // Producer warp: lane (a, b) copies segment data[a, d*NIN + b, i0:].
    const int lane = r - tn;
    const int a = lane / NIN, b = lane % NIN;
    const size_t nt = (size_t)NIN * offs.n;
    band_ring::Cursor cur{0, 1};
    for (int m = 0; m < my_tiles; ++m) {
      const int i0 = ((int)blockIdx.x + m * (int)gridDim.x) * tn;
      const uint32_t bytes = (uint32_t)(min(tn, nbp - i0) * sizeof(T));
      const band_ring::WindowUse win(m, my_tiles);
      band_ring::wait(bars->window_empty + win.buffer, win.parity ^ 1);
      band_ring::load_window(xw + win.buffer * NIN * w, x + ghost, NIN,
                             nbp + 2 * ghost, -ghost, nbp + ghost, i0 + dlo,
                             w, bars->window_full + win.buffer);
      for (int d = 0; d < offs.n; ++d) {
        band_ring::wait(bars->empty + cur.slot, cur.parity);
        uint64_t* full = bars->full + cur.slot;
        if (lane == 0) band_ring::expect_bytes(full, NOUT * NIN * bytes);
        __syncwarp();
        if (lane < NOUT * NIN) {
          band_ring::bulk_load(
              ring + (size_t)cur.slot * slot_values + lane * tn,
              data + (a * nt + (size_t)d * NIN + b) * nbp + i0, bytes, full);
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
    const T* xr = xw + win.buffer * NIN * w + (r - dlo);
    for (int d = 0; d < offs.n; ++d) {
      band_ring::wait(bars->full + cur.slot, cur.parity);
      const T* seg = ring + (size_t)cur.slot * slot_values + r;
      const T* xc = xr + offs.d[d];
#pragma unroll
      for (int b = 0; b < NIN; ++b) {
        const A xv = A(xc[b * w]);
#pragma unroll
        for (int a = 0; a < NOUT; ++a) {
          acc[a] += A(seg[(a * NIN + b) * tn]) * xv;
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

// What a tiled launch needs beside the tensors.
struct TiledLaunch {
  int nb, nbp, ghost, tn, stages, grid, dlo, w;
  size_t smem;
  NodeOffsets offs;
  cudaStream_t stream;
};

template <typename T, int NOUT, int NIN>
int launch_tiled_form(const T* data, const T* x, T* y, const TiledLaunch& l) {
  auto kernel = plane_spmv_tiled_kernel<T, NOUT, NIN>;
  static bool allowed[band_ring::kDevices] = {};   // of this instantiation
  const cudaError_t rc = band_ring::allow_full_smem(kernel, allowed);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<l.grid, l.tn + band_ring::kProducerThreads, l.smem, l.stream>>>(
      data, x, y, l.nb, l.nbp, l.ghost, l.tn, l.stages, l.dlo, l.w, l.offs);
  return (int)cudaGetLastError();
}

template <typename T, int NOUT>
int launch_tiled_nout(int n_in, const T* data, const T* x, T* y,
                      const TiledLaunch& l) {
  switch (n_in) {
    case 1: return launch_tiled_form<T, NOUT, 1>(data, x, y, l);
    case 2: return launch_tiled_form<T, NOUT, 2>(data, x, y, l);
    case 3: return launch_tiled_form<T, NOUT, 3>(data, x, y, l);
    default: return launch_tiled_form<T, NOUT, 4>(data, x, y, l);
  }
}

// `tn`, `stages` and `grid` are the wrapper's tile plan (ops/plane_dia.py
// tile_plan); what the plan must satisfy is checked again here.
template <typename T>
int launch_tiled(const void* data, const void* x, void* y, int n_out, int n_in,
                 int n_d, int nb, int nbp, int ghost, const int* offsets,
                 int tn, int stages, int grid, void* stream) {
  if (bad_shape(n_out, n_in, n_d, nb, nbp, ghost, offsets) || tn < 32 ||
      tn > kMaxTile || tn % 32 != 0 || stages < 1 ||
      stages > band_ring::kMaxStages || grid < 1 ||
      grid > (nbp + tn - 1) / tn ||
      ((size_t)nbp * sizeof(T)) % 16 != 0 ||
      ((size_t)ghost * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int dlo = offsets[0], dhi = offsets[0];
  for (int t = 1; t < n_d; ++t) {
    dlo = offsets[t] < dlo ? offsets[t] : dlo;
    dhi = offsets[t] > dhi ? offsets[t] : dhi;
  }
  dlo = band_ring::round_down(dlo, band_ring::align_values<T>());
  dhi = band_ring::round_up(dhi, band_ring::align_values<T>());
  const long long w = (long long)tn + dhi - dlo;
  const int windows = band_ring::window_buffers((nbp + tn - 1) / tn, grid);
  const long long smem =
      band_ring::kHeaderBytes +
      ((long long)stages * n_out * n_in * tn + windows * n_in * w) *
          (long long)sizeof(T);
  if (smem > band_ring::kSmemLimit) return (int)cudaErrorInvalidValue;

  const TiledLaunch l{nb,     nbp,    ghost,        tn,
                      stages, grid,   dlo,          (int)w,
                      (size_t)smem,   pack(offsets, n_d),
                      static_cast<cudaStream_t>(stream)};
  const T* d = static_cast<const T*>(data);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  switch (n_out) {
    case 1: return launch_tiled_nout<T, 1>(n_in, d, xv, yv, l);
    case 2: return launch_tiled_nout<T, 2>(n_in, d, xv, yv, l);
    case 3: return launch_tiled_nout<T, 3>(n_in, d, xv, yv, l);
    default: return launch_tiled_nout<T, 4>(n_in, d, xv, yv, l);
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
                                    int tn, int stages, int grid,
                                    void* stream) {
  return launch_tiled<float>(data, x, y, n_out, n_in, n_d, nb, nbp, ghost,
                             offsets, tn, stages, grid, stream);
}

extern "C" int plane_spmv_tiled_f64(const void* data, const void* x, void* y,
                                    int n_out, int n_in, int n_d, int nb,
                                    int nbp, int ghost, const int* offsets,
                                    int tn, int stages, int grid,
                                    void* stream) {
  return launch_tiled<double>(data, x, y, n_out, n_in, n_d, nb, nbp, ghost,
                              offsets, tn, stages, grid, stream);
}
