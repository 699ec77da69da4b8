"""Fused matrix powers z = A^p x, p = 2..4: kernel K4 and its plain version.

The counterpart of the JAX package's `ops/mpk_pallas.py` (the reference's
SpM2V/SpM3V/SpM4V): the intermediates A^j x, j < p, of one scalar-DIA
operator (offsets, data (K, n)) are computed tile by tile in on-chip memory
and never written out.  `spmpv_dia` runs K4 (`csrc/mpk.cu`, one launch per
A^p x) for tensors on the card and `spmpv_dia_plain` for tensors on the
CPU.  The benchmark entry point `bench/spmv_bench.py` (`--kernel
spm2v|spm3v|spm4v`) is the one caller, as in the JAX package.

The JAX package's overlap-tiled copy of A (`pretile_dia_overlap`) is not
carried over: it gave a TPU block DMA its halo rows, and a CTA reads the
rows it needs from the (K, n) data in place.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from navierstokes_tpu_torch.ops import cuda_lib
from navierstokes_tpu_torch.ops.dia import _check as _check_dia, spmv_dia_plain
from navierstokes_tpu_torch.ops.mpk import matrix_power

POWERS = (2, 3, 4)
SMEM_OPTIN = 232_448     # bytes of shared memory one CTA may use on the H100
N_SM = 132               # streaming multiprocessors of the H100 SXM
MIN_TILE = 32

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


def frame_values(tile: int, h: int, power: int) -> int:
    """Values of shared memory K4's two ping-pong frames take."""
    return tile + 2 * (power - 1) * h + (
        tile + 2 * (power - 2) * h if power > 2 else 0)


def choose_tile(n: int, offsets, *, power: int, itemsize: int,
                n_sm: int = N_SM, smem: int = SMEM_OPTIN) -> int:
    """K4's row tile T: as large as the frames allow in `smem` bytes, but no
    larger than one tile per SM (ceil(n / n_sm) rounded up to 32).  A
    larger tile reads A fewer times; fewer tiles than SMs leave SMs idle.
    Raises when even a 32-row tile does not fit."""
    h = halo(offsets)
    per_tile = 2 if power > 2 else 1
    fit = (smem // itemsize - frame_values(0, h, power)) // per_tile
    fit -= fit % MIN_TILE
    if fit < MIN_TILE:
        raise ValueError(
            f"K4 cannot fuse A^{power} x at halo h={h}: even a {MIN_TILE}-row "
            f"tile needs {frame_values(MIN_TILE, h, power) * itemsize} bytes "
            f"of shared memory, more than {smem}")
    want = -(-n // n_sm)
    want = -(-want // MIN_TILE) * MIN_TILE
    return min(fit, max(want, MIN_TILE))


def overlap_ratio(n: int, offsets, *, power: int, tile: int) -> float:
    """Passes over A's rows that K4 makes with row tile `tile`: each sweep
    reads the data rows of its frame (clipped to [0, n)), so the rows read
    over all tiles and sweeps, divided by n.  p chained SpMVs make p."""
    h = halo(offsets)
    rows = 0
    for it in range(0, n, tile):
        for j in range(1, power + 1):
            lo = max(it - (power - j) * h, 0)
            hi = min(it + tile + (power - j) * h, n)
            rows += hi - lo
    return rows / n


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


_C_FUNCS = {torch.float32: "mpk_spmpv_f32", torch.float64: "mpk_spmpv_f64"}


@functools.cache
def _kernel_fn(dtype: torch.dtype):
    """The C entry point of K4 for `dtype`, built and typed on first use."""
    lib, _ = cuda_lib.load("mpk")
    fn = getattr(lib, _C_FUNCS[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def device_tile(n: int, offsets, *, power: int, dtype: torch.dtype,
                device) -> int:
    """`choose_tile` for `device`: a card's own SM count, the H100's for
    the CPU (where the tile only labels the plain version's result)."""
    device = torch.device(device)
    n_sm = (torch.cuda.get_device_properties(device).multi_processor_count
            if device.type == "cuda" else N_SM)
    return choose_tile(n, offsets, power=power,
                       itemsize=torch.empty((), dtype=dtype).element_size(),
                       n_sm=n_sm)


def spmpv_dia_cuda(offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
                   power: int, tile=None) -> torch.Tensor:
    """K4 on the card: one launch on the current stream, no sync.  `tile`
    defaults to `device_tile`."""
    global kernel_launches
    n = _check(offsets, data, x, power)
    if data.device.type != "cuda":
        raise ValueError(f"K4 needs CUDA tensors, got {data.device}")
    if data.dtype not in _C_FUNCS:
        raise TypeError(f"K4 takes float32 or float64, got {data.dtype}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("K4 needs contiguous data and x")
    if tile is None:
        tile = device_tile(n, offsets, power=power, dtype=data.dtype,
                           device=data.device)
    fn = _kernel_fn(data.dtype)
    z = torch.empty((n,), dtype=x.dtype, device=x.device)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), x.data_ptr(), z.data_ptr(), len(offsets), n,
                offs, power, tile, stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {rc}")
    kernel_launches += 1
    return z


def spmpv_dia(offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
              power: int, tile=None) -> torch.Tensor:
    """z = A^power x for the scalar-DIA operator (offsets, data), power in
    {2, 3, 4}, in one sweep.

    The counterpart of the JAX package's `spmpv_dia_pallas` on the plain
    (K, n) data.  A CUDA tensor goes through K4 (or raises); a CPU tensor
    through the plain version (for which `tile` means nothing)."""
    if x.device.type == "cpu":
        return spmpv_dia_plain(offsets, data, x, power=power)
    return spmpv_dia_cuda(offsets, data, x, power=power, tile=tile)


def spm2v_dia(offsets: tuple, data: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """z = A^2 x in one sweep (`spmpv_dia` with power 2)."""
    return spmpv_dia(offsets, data, x, power=2)

