"""What Python decides for the persistent kernels K3 and K4.

Both run as one cooperative launch of G blocks, block b owning a slab of
[0, n) (`csrc/grid_sync.cuh`).  The slab split is mirrored here, in code the
CPU tests reach; the wrappers compute their plans from it, and the kernels
compute the same slabs again from the grid they are launched with.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from navierstokes_tpu_torch.ops import cuda_lib
from navierstokes_tpu_torch.ops.band_ring import COPY_ALIGN, sm_count


def slab_begin(b: int, grid: int, n: int, itemsize: int) -> int:
    """First index of slab b of `grid` over [0, n): a multiple of 16 bytes
    (`slab_begin` of grid_sync.cuh)."""
    align = COPY_ALIGN // itemsize
    units = -(-n // align)
    return min(n, align * (b * units // grid))


def slab_cuts(n: int, grid: int, itemsize: int) -> list:
    """The grid + 1 cut points of the split, 0 first and n last."""
    return [slab_begin(b, grid, n, itemsize) for b in range(grid + 1)]


def max_slab(n: int, grid: int, itemsize: int) -> int:
    """The longest slab: the row stride of a slab in shared memory."""
    align = COPY_ALIGN // itemsize
    units = -(-n // align)
    return align * -(-units // grid)


@functools.cache
def grid_blocks(lib: str, query: str, device: torch.device, smem: int,
                *lead: int) -> int:
    """G for a kernel whose occupancy query is the C function `query` of
    library `lib`, `query(*lead, smem, &out)`: the SM count times the
    blocks one SM holds at `smem` bytes.  Asked once per kernel, device and
    size.  Raises where not one block fits."""
    fn = getattr(cuda_lib.load(lib)[0], query)
    fn.argtypes = [ctypes.c_int] * (len(lead) + 1) + [
        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(*lead, smem, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"occupancy query {query} failed: cudaError {rc}")
    if out.value < 1:
        raise RuntimeError(f"no block of {query} fits an SM at {smem} bytes "
                           "of shared memory")
    return sm_count(device) * out.value


@functools.cache
def _floor_fn():
    lib, _ = cuda_lib.load("mpk")
    fn = lib.grid_sync_floor
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def empty_launch(grid: int, smem: int, barriers: int,
                 device: torch.device) -> None:
    """One cooperative launch of grid_sync.cuh's empty kernel (carried by
    K4's library) on the current stream: `grid` blocks of the width of K3
    and K4, `smem` bytes of shared memory each, `barriers` grid barriers
    and no work.  What a persistent launch costs before any work."""
    with torch.cuda.device(device):
        rc = _floor_fn()(grid, smem, barriers,
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty cooperative launch failed: cudaError {rc}")
