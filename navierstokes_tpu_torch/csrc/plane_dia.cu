// Component-plane banded SpMV (kernel K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel navierstokes_tpu/ops/plane_dia.py::_plane_kernel
// (driven there by spmv_planes_pallas / spmv_plane_pallas).  It computes
//
//     y_a[i] = sum_{iD, b}  data[a, iD*n_in + b, i] * x_b[i + D[iD]]
//
// for a < n_out, b < n_in, over the N_D node offsets D, with the terms in
// `plane_terms` order (j = iD*n_in + b).  Layout: data (n_out, n_in*N_D, nbp),
// x (n_in, nbp) and y (n_out, nbp), all plane-major and contiguous.
//
// What bounds it: bytes.  Each operator value is read once and used for one
// multiply-add, 2 flops per 4 bytes in f32: 0.5 flop per operator byte, far
// below the card's ridge point.  The design only has to stream the operator
// at full bandwidth: one thread per node row i, the n_out accumulators in
// registers, and loads of data[a, j, i] that are coalesced along i.  The
// n_in x planes are read n_out*N_D times less often than the operator and
// stay in L1/L2.  At matrix 6 (nbp ~ 29.4k nodes, 4x4 planes, N_D = 15) the
// f32 operator is 28 MB and fits in the H100's 50 MB L2, so back-to-back
// applies inside one GMRES iteration mostly read it from L2.
//
// Edges: x_b[i + D] is read only where 0 <= i + D < nbp and counts as zero
// elsewhere.  This is the zero padding of x that the TPU kernel DMAs
// (plane_dia.py:203), without a padded copy of x: DIA storage does not
// guarantee zeros where i + D leaves the matrix.  Rows nb <= i < nbp are
// padding and are written as exact zeros.
//
// Accumulation is in float for f32 data and in double for f64 data
// (promote(dtype, f32), as in the TPU kernel).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxOffsets = 32;
constexpr int kMaxPlanes = 4;
constexpr int kThreads = 128;

struct NodeOffsets {
  int n;
  int d[kMaxOffsets];
};

template <typename T>
struct Accum {
  using type = float;
};
template <>
struct Accum<double> {
  using type = double;
};

template <typename T, int NOUT>
__global__ void __launch_bounds__(kThreads)
plane_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                  T* __restrict__ y, int n_in, int nb, int nbp,
                  NodeOffsets offs) {
  using A = typename Accum<T>::type;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nbp) return;
  if (i >= nb) {
#pragma unroll
    for (int a = 0; a < NOUT; ++a) y[(size_t)a * nbp + i] = T(0);
    return;
  }
  const size_t plane_stride = (size_t)n_in * offs.n * nbp;  // between a's
  A acc[NOUT];
#pragma unroll
  for (int a = 0; a < NOUT; ++a) acc[a] = A(0);

  const T* col = data + i;  // data[0, j, i], advanced by nbp per term j
  for (int t = 0; t < offs.n; ++t) {
    const int src = i + offs.d[t];
    const bool inside = src >= 0 && src < nbp;
    for (int b = 0; b < n_in; ++b, col += nbp) {
      const A xv = inside ? A(x[(size_t)b * nbp + src]) : A(0);
#pragma unroll
      for (int a = 0; a < NOUT; ++a) {
        acc[a] += A(col[a * plane_stride]) * xv;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NOUT; ++a) y[(size_t)a * nbp + i] = T(acc[a]);
}

template <typename T>
int launch(const void* data, const void* x, void* y, int n_out, int n_in,
           int n_d, int nb, int nbp, const int* offsets, void* stream) {
  if (n_out < 1 || n_out > kMaxPlanes || n_in < 1 || n_in > kMaxPlanes ||
      n_d < 1 || n_d > kMaxOffsets || nb < 0 || nb > nbp || nbp < 1 ||
      offsets == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  NodeOffsets offs;
  offs.n = n_d;
  for (int t = 0; t < kMaxOffsets; ++t) offs.d[t] = t < n_d ? offsets[t] : 0;

  const dim3 grid((nbp + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* d = static_cast<const T*>(data);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  switch (n_out) {
    case 1:
      plane_spmv_kernel<T, 1><<<grid, block, 0, s>>>(d, xv, yv, n_in, nb, nbp, offs);
      break;
    case 2:
      plane_spmv_kernel<T, 2><<<grid, block, 0, s>>>(d, xv, yv, n_in, nb, nbp, offs);
      break;
    case 3:
      plane_spmv_kernel<T, 3><<<grid, block, 0, s>>>(d, xv, yv, n_in, nb, nbp, offs);
      break;
    default:
      plane_spmv_kernel<T, 4><<<grid, block, 0, s>>>(d, xv, yv, n_in, nb, nbp, offs);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int plane_spmv_f32(const void* data, const void* x, void* y,
                              int n_out, int n_in, int n_d, int nb, int nbp,
                              const int* offsets, void* stream) {
  return launch<float>(data, x, y, n_out, n_in, n_d, nb, nbp, offsets, stream);
}

extern "C" int plane_spmv_f64(const void* data, const void* x, void* y,
                              int n_out, int n_in, int n_d, int nb, int nbp,
                              const int* offsets, void* stream) {
  return launch<double>(data, x, y, n_out, n_in, n_d, nb, nbp, offsets, stream);
}
