"""Fused matrix powers z = A^p x, p = 2..4: kernel K4 and its plain version.

The counterpart of the JAX package's `ops/mpk_pallas.py` (the reference's
SpM2V/SpM3V/SpM4V): the p applies of one scalar-DIA operator (offsets,
data (K, n)) in one launch.  `spmpv_dia` runs K4 (`csrc/mpk.cu`, one
persistent cooperative launch: each block keeps its row slab of as many
diagonals as fit in shared memory across the p passes, reads the source
of each pass from a window in shared memory, and waits at a grid barrier
between passes) for tensors on the card and `spmpv_dia_plain` for tensors
on the CPU.  The benchmark entry point `bench/spmv_bench.py` (`--kernel
spm2v|spm3v|spm4v`) is the one caller, as in the JAX package.

The JAX package's overlap-tiled copy of A (`pretile_dia_overlap`) is not
carried over: it gave a TPU block DMA its halo rows, and K4 has no halo.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from navierstokes_tpu_torch.ops import cuda_lib, grid_sync
from navierstokes_tpu_torch.ops.band_ring import (
    N_SM,
    SMEM_LIMIT,
    c_int_array,
    sm_count,
)
from navierstokes_tpu_torch.ops.dia import _check as _check_dia, spmv_dia_plain
from navierstokes_tpu_torch.ops.mpk import matrix_power

POWERS = (2, 3, 4)
HEADER_BYTES = 256       # kHeaderBytes of csrc/mpk.cu: the groups' mbarriers

# Plain integer counters: K4 launches, and calls of the plain version.
kernel_launches = 0
plain_calls = 0


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


def halo(offsets) -> int:
    """h = max |offset| (at least 1): how far one apply reaches."""
    return max(max(abs(d) for d in offsets), 1)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Shared memory of one K4 block: `ld` values per slab row, the source
    window of `window` values (0: none, the source is read in place), the
    first `resident` diagonals' slabs; `smem` bytes in all."""

    ld: int
    window: int
    resident: int
    smem: int


@functools.lru_cache(maxsize=256)
def plan(n: int, k: int, itemsize: int, grid: int = N_SM,
         span: int = 0) -> Plan:
    """K4's plan for K = `k` diagonals of n rows over `grid` blocks, the
    offsets spanning max - min = `span`: the mbarriers, then the window of
    the source the block's rows reach (its slab and the span) where that
    takes at most half the opt-in, then as many diagonals' row slabs as
    fit.  A grid of more blocks (more than one per SM) has shorter slabs,
    so the plan fits it too."""
    ld = grid_sync.max_slab(n, grid, itemsize)
    window = ld + span
    wbytes = -(-window * itemsize // 16) * 16
    if wbytes > (SMEM_LIMIT - HEADER_BYTES) // 2:
        window = wbytes = 0
    resident = min(k, (SMEM_LIMIT - HEADER_BYTES - wbytes) // (ld * itemsize))
    return Plan(ld, window, resident,
                HEADER_BYTES + wbytes + resident * ld * itemsize)


def passes_over_a(k: int, resident: int, power: int) -> float:
    """Reads of A per A^p x, in units of A: the resident diagonals once,
    the others in every pass (from HBM in the first; from L2 after where
    they fit there).  p chained SpMVs make p, the function's bound one."""
    return (resident + power * (k - resident)) / k


def _check(offsets, data: torch.Tensor, x: torch.Tensor, power: int) -> int:
    n = _check_dia(offsets, data, x)
    if power not in POWERS:
        raise ValueError(f"power {power}: the fused sweep takes {POWERS}")
    return n


def spmpv_dia_plain(offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
                    power: int) -> torch.Tensor:
    """Plain PyTorch K4: p chained applies of K2's plain version."""
    global plain_calls
    _check(offsets, data, x, power)
    plain_calls += 1
    return matrix_power(offsets, data, x, power, spmv=spmv_dia_plain)


_C_FUNCS = {torch.float32: "f32", torch.float64: "f64"}


@functools.cache
def _kernel_fn(dtype: torch.dtype):
    """The C entry point of K4 for `dtype`, built and typed on first use."""
    lib, _ = cuda_lib.load("mpk")
    fn = getattr(lib, f"mpk_spmpv_{_C_FUNCS[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def device_plan(n: int, offsets, dtype: torch.dtype, device) -> tuple:
    """(plan, grid) of K4 on `device`: the card's own SM count and
    occupancy; on the CPU, where they only label the plain version's
    result, the H100's 132 SMs with one block each."""
    device = torch.device(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    span = max(offsets) - min(offsets)
    if device.type != "cuda":
        return plan(n, len(offsets), itemsize, N_SM, span), N_SM
    pl = plan(n, len(offsets), itemsize, sm_count(device), span)
    return pl, grid_sync.grid_blocks(
        "mpk", f"mpk_blocks_per_sm_{_C_FUNCS[dtype]}", device, pl.smem)


def spmpv_dia_cuda(offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
                   power: int) -> torch.Tensor:
    """K4 on the card: one cooperative launch on the current stream, no
    sync.  Raises with the CUDA error where the launch is refused."""
    global kernel_launches
    n = _check(offsets, data, x, power)
    if data.device.type != "cuda":
        raise ValueError(f"K4 needs CUDA tensors, got {data.device}")
    if data.dtype not in _C_FUNCS:
        raise TypeError(f"K4 takes float32 or float64, got {data.dtype}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("K4 needs contiguous data and x")
    fn = _kernel_fn(data.dtype)
    pl, grid = device_plan(n, offsets, data.dtype, data.device)
    z = torch.empty((n,), dtype=x.dtype, device=x.device)
    ybuf = torch.empty((2 * n,), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), x.data_ptr(), z.data_ptr(), ybuf.data_ptr(),
                len(offsets), n, c_int_array(tuple(offsets)), power,
                pl.resident, pl.window, grid, pl.smem, stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {rc}")
    kernel_launches += 1
    return z


def spmpv_dia(offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
              power: int) -> torch.Tensor:
    """z = A^power x for the scalar-DIA operator (offsets, data), power in
    {2, 3, 4}, in one sweep.

    The counterpart of the JAX package's `spmpv_dia_pallas` on the plain
    (K, n) data.  A CUDA tensor goes through K4 (or raises); a CPU tensor
    through the plain version."""
    if x.device.type == "cpu":
        return spmpv_dia_plain(offsets, data, x, power=power)
    return spmpv_dia_cuda(offsets, data, x, power=power)


def spm2v_dia(offsets: tuple, data: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """z = A^2 x in one sweep (`spmpv_dia` with power 2)."""
    return spmpv_dia(offsets, data, x, power=2)

