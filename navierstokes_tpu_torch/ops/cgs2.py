"""Fused CGS2 projection: kernel K3 and its plain PyTorch version.

One classical Gram-Schmidt projection, done twice, of w against the live
rows 0..k of the Krylov basis V (row-major (m1, n)):

    h1 = V w;   w1 = w - V^T h1;   h2 = V w1;   w2 = w1 - V^T h2

returning (w2, h) with h = h1 + h2 of length m1, exactly zero beyond row
k.  Rows above k are never read.  GMRES calls it once per Arnoldi step
when `cgs2` is 'pallas' or 'pallas_comp' (`solvers/gmres.py`).
`cgs2_project` runs K3 (`csrc/cgs2.cu`, one persistent cooperative launch
that keeps each block's column slab of the live rows in shared memory)
for tensors on the card and `cgs2_project_plain` for tensors on the CPU.

The JAX package's kernel needs n to be a multiple of its tile, V padded to
8-row blocks and a tile-major copy of V; those were TPU layout rules, and
K3 takes any n and the port's plain (m1, n) basis.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from navierstokes_tpu_torch.ops import cuda_lib, grid_sync
from navierstokes_tpu_torch.ops.band_ring import N_SM, SMEM_LIMIT, sm_count

MAX_ROWS = 512            # kMaxRows of csrc/cgs2.cu: m1 = restart + 1 <= 512
HEADER_BYTES = 256        # kHeaderBytes: the mbarriers of the row groups
LAUNCHES = 1              # per projection: one cooperative launch

# Plain integer counters: K3 launches, and calls of the plain version.
kernel_launches = 0
plain_calls = 0


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


def _check(V: torch.Tensor, w: torch.Tensor, k: int) -> tuple:
    if V.dim() != 2:
        raise ValueError(f"V must be (m1, n), got {tuple(V.shape)}")
    m1, n = V.shape
    if w.shape != (n,):
        raise ValueError(f"w has shape {tuple(w.shape)}, expected ({n},)")
    if not 0 <= k < m1:
        raise ValueError(f"row bound k={k} outside [0, {m1})")
    if V.dtype != w.dtype:
        raise TypeError(f"dtype mismatch: V {V.dtype}, w {w.dtype}")
    if V.device != w.device:
        raise ValueError(f"device mismatch: V {V.device}, w {w.device}")
    return m1, n


@dataclasses.dataclass(frozen=True)
class Plan:
    """Shared memory of one K3 block (`layout` of csrc/cgs2.cu): `ld`
    values per slab row, the first `rows` (R) live rows of V resident,
    w1's slab resident where `w1_shared`; `smem` bytes in all."""

    ld: int
    rows: int
    w1_shared: bool
    smem: int


@functools.lru_cache(maxsize=1024)
def plan(n: int, k: int, itemsize: int, grid: int = N_SM) -> Plan:
    """K3's plan for rows 0..k of an (m1, n) basis over `grid` blocks: the
    mbarriers and h1, h2 first, then w1's slab where it fits, then as many
    live rows as fit the opt-in, R = min(k+1, what is left / row slab).
    A grid of more blocks (more than one per SM) has shorter slabs, so the
    plan fits it too."""
    ld = grid_sync.max_slab(n, grid, itemsize)
    row = ld * itemsize
    fixed = HEADER_BYTES + -(-2 * (k + 1) * itemsize // 16) * 16
    w1_shared = fixed + row <= SMEM_LIMIT
    if w1_shared:
        fixed += row
    rows = min(k + 1, (SMEM_LIMIT - fixed) // row)
    return Plan(ld, rows, w1_shared, fixed + rows * row)


def passes_over_v(k: int, rows: int) -> float:
    """Reads of V[:k+1] per projection, in units of V[:k+1]: the R resident
    rows once, the others in each of the three phases.  The function's
    bound reads it once; three separate sweeps read it three times."""
    return (rows + 3 * (k + 1 - rows)) / (k + 1)


def cgs2_project_plain(V: torch.Tensor, w: torch.Tensor, k: int, *,
                       compensated: bool = False) -> tuple:
    """Plain PyTorch K3: the same three sweeps over rows 0..k, accumulated
    in promote(dtype, float32).  With `compensated` the h sums are taken in
    float64, which is what the kernel's compensated sums approach."""
    global plain_calls
    m1, n = _check(V, w, k)
    plain_calls += 1
    acc = torch.promote_types(V.dtype, torch.float32)
    hacc = torch.float64 if compensated else acc
    Vk = V[:k + 1].to(acc)
    h1 = (Vk.to(hacc) @ w.to(hacc)).to(acc)
    w1 = w.to(acc) - Vk.T @ h1
    h2 = (Vk.to(hacc) @ w1.to(hacc)).to(acc)
    w2 = w1 - Vk.T @ h2
    h = torch.zeros(m1, dtype=acc, device=V.device)
    h[:k + 1] = h1 + h2
    return w2.to(V.dtype), h.to(V.dtype)


_C_FUNCS = {torch.float32: "f32", torch.float64: "f64"}


@functools.cache
def _kernel_fn(dtype: torch.dtype):
    """The C entry point of K3 for `dtype`, built and typed on first use."""
    lib, _ = cuda_lib.load("cgs2")
    fn = getattr(lib, f"cgs2_project_{_C_FUNCS[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def device_plan(n: int, k: int, dtype: torch.dtype, compensated: bool,
                device) -> tuple:
    """(plan, grid) of K3 on a CUDA `device`: the plan for its SM count and
    G = SMs x the blocks one SM holds at the plan's shared memory."""
    pl = plan(n, k, torch.empty((), dtype=dtype).element_size(),
              sm_count(device))
    return pl, grid_sync.grid_blocks(
        "cgs2", f"cgs2_blocks_per_sm_{_C_FUNCS[dtype]}", device, pl.smem,
        int(compensated))


def cgs2_project_cuda(V: torch.Tensor, w: torch.Tensor, k: int, *,
                      compensated: bool = False) -> tuple:
    """K3 on the card: one cooperative launch on the current stream, no
    sync.  Raises with the CUDA error where the launch is refused (a grid
    that cannot be resident all at once, for one)."""
    global kernel_launches
    m1, n = _check(V, w, k)
    if V.device.type != "cuda":
        raise ValueError(f"K3 needs CUDA tensors, got {V.device}")
    if V.dtype not in _C_FUNCS:
        raise TypeError(f"K3 takes float32 or float64, got {V.dtype}")
    if m1 > MAX_ROWS:
        raise ValueError(f"K3 takes at most {MAX_ROWS} basis rows "
                         f"(restart <= {MAX_ROWS - 1}), got {m1}")
    if not (V.is_contiguous() and w.is_contiguous()):
        raise ValueError("K3 needs a contiguous V and w")
    fn = _kernel_fn(V.dtype)
    pl, grid = device_plan(n, k, V.dtype, compensated, V.device)
    w2 = torch.empty_like(w)
    h = torch.empty(m1, dtype=V.dtype, device=V.device)
    part = torch.empty(2 * (k + 1) * grid, dtype=V.dtype, device=V.device)
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(V.data_ptr(), w.data_ptr(), w2.data_ptr(), h.data_ptr(),
                part.data_ptr(), n, m1, k, pl.rows, int(pl.w1_shared), grid,
                pl.smem, int(compensated), stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc}")
    kernel_launches += LAUNCHES
    return w2, h


def cgs2_project(V: torch.Tensor, w: torch.Tensor, k: int, *,
                 compensated: bool = False) -> tuple:
    """(w2, h): one CGS2 projection of w against rows 0..k of V.

    The counterpart of the JAX package's `cgs2_project`: V (m1, n) with any
    n, w (n,), k a host int in [0, m1).  A CUDA tensor goes through K3 (or
    raises); a CPU tensor through the plain version."""
    if V.device.type == "cpu":
        return cgs2_project_plain(V, w, k, compensated=compensated)
    return cgs2_project_cuda(V, w, k, compensated=compensated)
