"""Scalar-DIA SpMV: kernel K2 and its plain PyTorch version.

    y[i] = sum_k  data[k, i] * x[i + offsets[k]],   x[j] = 0 outside [0, n)

with data (K, n) and x (n,).  The scalar-DIA path runs every operator apply
through it: the operator A of the two-level path ('tl') or S = D^{-1} A of
the block-Jacobi path ('bj'), the 7-diagonal block-diagonal D^{-1}, the
multilevel coarse level and the scalar residual.  `spmv_dia` applies it
through the CUDA kernel K2 (`csrc/dia.cu`) for tensors on the card, and
through `spmv_dia_plain` for tensors on the CPU.

Data and x share one dtype (float32 or float64), or data is bfloat16 and x
float32 or float64 (`matvec_dtype='bfloat16'` on the 'tl' and 'bj' paths):
then the products and the sum are taken in x's dtype and y is in x's
dtype, the semantics of the JAX package's `spmv_dia` on bf16 data.

The ghost-row form (`halo=g > 0`, the JAX package's `x_prehalo=True`): x
holds n + 2g values, x[g + j] for j in [-g, n + g), where the distributed
solver's halo exchange has put the neighbouring shards' rows
(`parallel/partitioned.py`); with g >= max|offset| nothing is masked,

    y[i] = sum_k  data[k, i] * x[g + i + offsets[k]].

K2 has two routes that compute the same function bit for bit
(`dia_route` picks one by form, ghost rows, size and alignment): 'rows', one thread per row (two for bf16 data) with 8
diagonals' loads in flight, and 'tiled', one block per tile of rows sized
to fill the card, each thread's next chunk of DEPTH diagonals (operator
values and x) in flight while it sums the chunk in hand (`csrc/dia.cu`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from navierstokes_tpu_torch.ops import band_ring, cuda_lib

MAX_DIAGONALS = 256       # kMaxDiagonals of csrc/dia.cu
MAX_THREADS = 256         # kMaxThreads: threads of a tile of the tiled route
DEPTH = 16                # kDepth: diagonals of a chunk of the tiled route
ROUTES = ("tiled", "rows")

# Plain integer counters: K2 launches (halo_launches: those of the
# ghost-row form; route_launches: by route), and calls of the plain
# version; form_launches counts K2 launches by form, "<data dtype>/<x
# dtype>" (for example "bfloat16/float32"), with " halo" added for the
# ghost-row form.
kernel_launches = 0
halo_launches = 0
route_launches = dict.fromkeys(ROUTES, 0)
plain_calls = 0
form_launches: dict = {}


def reset_counters() -> None:
    global kernel_launches, halo_launches, plain_calls
    kernel_launches = 0
    halo_launches = 0
    plain_calls = 0
    for route in ROUTES:
        route_launches[route] = 0
    form_launches.clear()


def _check(offsets, data: torch.Tensor, x: torch.Tensor,
           halo: int = 0) -> int:
    if data.dim() != 2:
        raise ValueError(f"DIA data must be (K, n), got {tuple(data.shape)}")
    k, n = data.shape
    if len(offsets) != k:
        raise ValueError(f"{len(offsets)} offsets for {k} diagonals")
    if not 1 <= k <= MAX_DIAGONALS:
        raise ValueError(f"{k} diagonals; K2 takes 1..{MAX_DIAGONALS}")
    if halo < 0 or (halo and halo < max(abs(d) for d in offsets)):
        raise ValueError(f"ghost width {halo}: 0, or at least the band's "
                         f"{max(abs(d) for d in offsets)}")
    if x.shape != (n + 2 * halo,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({n + 2 * halo},)")
    if x.dtype == torch.bfloat16:
        raise TypeError("x must be float32 or float64: bfloat16 is a "
                        "storage dtype of the operator only")
    if data.dtype != x.dtype and not (
            data.dtype == torch.bfloat16
            and x.dtype in (torch.float32, torch.float64)):
        raise TypeError(f"dtype mismatch: data {data.dtype}, x {x.dtype}")
    if data.device != x.device:
        raise ValueError(f"device mismatch: data {data.device}, x {x.device}")
    return n


def spmv_dia_plain(offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
                   halo: int = 0) -> torch.Tensor:
    """Plain PyTorch K2: one shifted-slice multiply-add per diagonal, in the
    kernel's order, accumulated in promote(x.dtype, float32); masked at the
    matrix's edges, or over the ghost rows where `halo` > 0."""
    global plain_calls
    n = _check(offsets, data, x, halo)
    plain_calls += 1
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xa = x.to(acc_dtype)
    y = torch.zeros(n, dtype=acc_dtype, device=x.device)
    for k, d in enumerate(offsets):
        lo, hi = (0, n) if halo else (max(0, -d), min(n, n - d))
        if hi > lo:
            y[lo:hi] += data[k, lo:hi].to(acc_dtype) \
                * xa[halo + lo + d:halo + hi + d]
    return y.to(x.dtype)


class TilePlan(NamedTuple):
    """The tiled route's launch: one block per tile of `tn` rows (one a
    thread, two for bf16 data, in `threads` threads: whole warps), `n_tiles`
    tiles."""

    tn: int
    n_tiles: int
    threads: int


def plan_text(plan: TilePlan) -> str:
    """One line of a tile plan, as the card's checks print it."""
    return (f"tile {plan.tn}, {plan.n_tiles} tiles of {plan.threads} "
            f"threads, chunks of {DEPTH} diagonals")


@functools.lru_cache(maxsize=256)
def tile_plan(n: int, data_itemsize: int,
              n_sm: int = band_ring.N_SM) -> TilePlan | None:
    """The tiled route's plan for data (K, n) of `data_itemsize` bytes, or
    None where the route does not take the shape: an odd n with bf16 data
    (a thread loads a pair of rows as 4 bytes).  Tiles of whole warps of
    rows, at most MAX_THREADS threads, fill `n_sm` SMs in whole waves
    (`band_ring.wave_tile`); tile t owns rows [t * tn, min((t + 1) * tn,
    n)).  Cached: a solver loop asks for the same plan at every launch."""
    rows = 2 if data_itemsize == 2 else 1
    if n % rows:
        return None
    tn = band_ring.wave_tile(n, n_sm, MAX_THREADS * rows)
    return TilePlan(tn, -(-n // tn),
                    -(-tn // (rows * band_ring.WARP)) * band_ring.WARP)


def tiled_plan(data: torch.Tensor,
               n_sm: int = band_ring.N_SM) -> TilePlan | None:
    """The tiled route's plan for this operator, or None where the route
    does not take it: `tile_plan` of its shape, and bf16 data must start on
    4 bytes (a load of a row pair)."""
    if data.dtype == torch.bfloat16 and data.data_ptr() % 4:
        return None
    return tile_plan(data.shape[1], data.element_size(), n_sm)


# Threads per SM up to which the tiled route was measured faster than
# 'rows' in turns on an H100, flushed and L2-warm (PERF.md,
# `chip_smoke.py`): one tile per SM for every form with ghost rows (a
# shard of matrix 6 in 4 or 8: A, S and D^-1 in f32, f64 and bf16); two
# for bf16 data with f32 x (matrix 6's A and S, 446 threads per SM).  At
# ~970 (a shard of matrix 8) and ~890 (the whole matrix-6 vector in f32 or
# f64, masked) 'rows' was faster.
TILED_MAX_PER_SM = 256
TILED_BF16_MAX_PER_SM = 448


def dia_route(data: torch.Tensor, x: torch.Tensor,
              n_sm: int = band_ring.N_SM, halo: int = 0) -> str:
    """Which K2 route `spmv_dia` takes: 'tiled' where `tiled_plan` has a
    plan and the form and size are where it measured faster, bf16 data
    with f32 x at up to TILED_BF16_MAX_PER_SM threads per SM, or any data
    with ghost rows at up to TILED_MAX_PER_SM; else 'rows' (every masked
    f32 or f64 form, the larger shards, bf16 data with f64 x beyond one
    tile per SM).  Nothing but the form, the shapes and the alignment
    decides."""
    rows = 2 if data.dtype == torch.bfloat16 else 1
    per_sm = -(-(-(-data.shape[1] // rows)) // n_sm)
    if data.dtype == torch.bfloat16 and x.dtype == torch.float32:
        wanted = per_sm <= TILED_BF16_MAX_PER_SM
    else:
        wanted = halo > 0 and per_sm <= TILED_MAX_PER_SM
    return "tiled" if wanted and tiled_plan(data, n_sm) else "rows"


# (route, data dtype, x dtype) -> the C entry point of K2
_C_FUNCS = {
    ("rows", torch.float32, torch.float32): "dia_spmv_f32",
    ("rows", torch.float64, torch.float64): "dia_spmv_f64",
    ("rows", torch.bfloat16, torch.float32): "dia_spmv_bf16_f32",
    ("rows", torch.bfloat16, torch.float64): "dia_spmv_bf16_f64",
    ("tiled", torch.float32, torch.float32): "dia_spmv_tiled_f32",
    ("tiled", torch.float64, torch.float64): "dia_spmv_tiled_f64",
    ("tiled", torch.bfloat16, torch.float32): "dia_spmv_tiled_bf16_f32",
    ("tiled", torch.bfloat16, torch.float64): "dia_spmv_tiled_bf16_f64",
}


@functools.cache
def _kernel_fn(route: str, data_dtype: torch.dtype, x_dtype: torch.dtype):
    """The C entry point of K2's `route` for a (data, x) dtype form, built
    and typed on first use."""
    lib, _ = cuda_lib.load("dia")
    fn = getattr(lib, _C_FUNCS[route, data_dtype, x_dtype])
    plan_args = [ctypes.c_int] if route == "tiled" else []
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), *plan_args,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmv_dia_cuda(offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
                  halo: int = 0, route: str | None = None) -> torch.Tensor:
    """K2 on the card: one launch on the current stream, no sync.

    `route` None takes `dia_route`'s choice; 'tiled' or 'rows' forces one
    (the comparison of the two on the card) and raises where the operator
    does not fit it.  No route falls back to another."""
    global kernel_launches, halo_launches
    n = _check(offsets, data, x, halo)
    if data.device.type != "cuda":
        raise ValueError(f"K2 needs CUDA tensors, got {data.device}")
    if ("rows", data.dtype, x.dtype) not in _C_FUNCS:
        raise TypeError(f"K2 takes float32 or float64 data, or bfloat16 "
                        f"data with float32 or float64 x; got {data.dtype}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("K2 needs contiguous data and x")
    if route not in (None,) + ROUTES:
        raise ValueError(f"K2 route {route!r}: one of {ROUTES}")
    n_sm = band_ring.sm_count(x.device)
    if route is None:
        route = dia_route(data, x, n_sm, halo)
    plan_args = ()
    if route == "tiled":
        plan = tiled_plan(data, n_sm)
        if plan is None:
            raise ValueError(
                f"K2's tiled route does not take this operator (n={n}, "
                f"{data.dtype}): bf16 data needs an even n and to start "
                "on 4 bytes")
        plan_args = (plan.tn,)
    fn = _kernel_fn(route, data.dtype, x.dtype)
    y = torch.empty((n,), dtype=x.dtype, device=x.device)
    offs = band_ring.c_int_array(tuple(offsets))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), x.data_ptr(), y.data_ptr(), len(offsets), n,
                halo, offs, *plan_args, stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed ({route}): cudaError {rc}")
    kernel_launches += 1
    route_launches[route] += 1
    key = f"{str(data.dtype)[6:]}/{str(x.dtype)[6:]}"
    if halo:
        halo_launches += 1
        key += " halo"
    form_launches[key] = form_launches.get(key, 0) + 1
    return y


def spmv_dia(offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
             halo: int = 0) -> torch.Tensor:
    """y = A x for the scalar-DIA operator (offsets, data).

    The counterpart of the JAX package's `spmv_dia_pallas`: data (K, n)
    in x's dtype or bfloat16, x (n,), or (n + 2 halo,) in the ghost-row
    form, returns (n,) in x's dtype.  A CUDA tensor goes through K2 (or
    raises); a CPU tensor through the plain version."""
    if x.device.type == "cpu":
        return spmv_dia_plain(offsets, data, x, halo=halo)
    return spmv_dia_cuda(offsets, data, x, halo=halo)
