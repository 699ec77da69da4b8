// Persistent, cooperatively launched kernels on Hopper (sm_90a): what
// kernels K3 (cgs2.cu) and K4 (mpk.cu) share.
//
// Both kernels are one data dependency across the whole vector, repeated a
// few times (K3: two global reductions; K4: p - 1 full SpMVs).  Each runs as
// one launch of G blocks that are all resident at once (a cooperative launch
// refuses a grid that cannot be), one or a few per SM.  Block b owns a
// contiguous slab of [0, n), copies its slab of the operator into shared
// memory once, and runs the phases with grid-wide barriers between them.
//
// The barrier is the flip barrier of cooperative groups: every block's
// thread 0 adds to one word in device memory, block 0 adds 2^31 - (G - 1)
// and the others 1, so that the word's top bit flips exactly when the last
// block arrives and the low bits come back to where they were.  The word
// never needs a reset, from one barrier or one launch to the next.  Its
// wait is bounded: a barrier that does not complete (a block that never
// arrives) traps, which shows as a launch error in the wrapper, instead of
// hanging the card.  The word is one per library, so launches that use it
// must not run at the same time on two streams; the port launches on the
// current stream only.
//
// Memory order: __syncthreads() gathers the block's writes, thread 0's
// __threadfence() publishes them at GPU scope before it arrives, and its
// ld.acquire.gpu of the flipped word, followed by __syncthreads(), makes the
// other blocks' writes visible to the whole block.  Data that one block
// writes and another reads after a barrier must then be read with plain
// loads: never __ldg and never through a `const T* __restrict__` parameter,
// which the compiler may turn into ld.global.nc, whose cache is not kept
// coherent within a launch.
//
// Slabs: [0, n) is cut into G slabs whose bounds are multiples of 16 bytes
// (`align` values), as even as that allows.  A slab of a 16-byte aligned
// row is then a legal bulk copy (band_ring.cuh's `bulk_load`).
// ops/grid_sync.py mirrors slab_begin and max_slab for the wrappers and
// the CPU tests.

#pragma once

#include <cuda_runtime.h>

#include "band_ring.cuh"

namespace grid_sync {

namespace {
__device__ unsigned int barrier_word;  // zero when the library loads
}  // namespace

constexpr unsigned int kFlip = 0x80000000u;

// First index of slab b of G over [0, n), in units of `align` values.
__host__ __device__ __forceinline__ int slab_begin(int b, int grid, int n,
                                                   int align) {
  const long long units = (n + align - 1) / align;
  const long long v = (long long)align * ((long long)b * units / grid);
  return v < n ? (int)v : n;
}

// The longest slab of the split: the row stride of a slab in shared memory.
__host__ __device__ __forceinline__ int max_slab(int n, int grid, int align) {
  const int units = (n + align - 1) / align;
  return align * ((units + grid - 1) / grid);
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid waits here until all have arrived; every write
// made before it, by any block, is visible after it.
__device__ __forceinline__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? kFlip - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(&barrier_word, add);
    const long long t0 = clock64();
    while (((load_acquire(&barrier_word) ^ old) & kFlip) == 0) {
      if (clock64() - t0 > band_ring::kWaitCycles) __trap();
    }
  }
  __syncthreads();
}

// Host: blocks of `kernel` that fit on one SM at `threads` threads and
// `smem` bytes of dynamic shared memory.  The kernel is first allowed the
// whole opt-in (band_ring::allow_full_smem), as its launch will be.
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int threads, int smem,
                          bool (&allowed)[band_ring::kDevices], int* out) {
  cudaError_t rc = band_ring::allow_full_smem(kernel, allowed);
  if (rc != cudaSuccess) return rc;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                       (size_t)smem);
}

// Host: the one launch of a persistent kernel.  Refused, with the CUDA
// error, when the grid cannot be resident all at once.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int grid, int threads, int smem,
                   cudaStream_t stream, void** args) {
  cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(threads), args,
      (size_t)smem, stream);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

// A kernel that does nothing but `barriers` grid barriers: launched like
// K3 or K4, it measures what the cooperative launch and its barriers cost.
// (A template, so that only a library that launches it compiles it.)
template <int kUnused = 0>
__global__ void empty_kernel(int barriers) {
  for (int i = 0; i < barriers; ++i) grid_barrier();
}

}  // namespace grid_sync
