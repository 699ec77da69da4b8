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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from navierstokes_tpu_torch.ops import cuda_lib

MAX_DIAGONALS = 256       # kMaxDiagonals of csrc/dia.cu

# Plain integer counters: K2 launches (halo_launches: those of the
# ghost-row form), and calls of the plain version; form_launches counts K2
# launches by form, "<data dtype>/<x dtype>" (for example
# "bfloat16/float32"), with " halo" added for the ghost-row form.
kernel_launches = 0
halo_launches = 0
plain_calls = 0
form_launches: dict = {}


def reset_counters() -> None:
    global kernel_launches, halo_launches, plain_calls
    kernel_launches = 0
    halo_launches = 0
    plain_calls = 0
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


# (data dtype, x dtype) -> the C entry point of K2
_C_FUNCS = {
    (torch.float32, torch.float32): "dia_spmv_f32",
    (torch.float64, torch.float64): "dia_spmv_f64",
    (torch.bfloat16, torch.float32): "dia_spmv_bf16_f32",
    (torch.bfloat16, torch.float64): "dia_spmv_bf16_f64",
}


@functools.cache
def _kernel_fn(form: tuple):
    """The C entry point of K2 for `form` = (data dtype, x dtype), built and
    typed on first use."""
    lib, _ = cuda_lib.load("dia")
    fn = getattr(lib, _C_FUNCS[form])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmv_dia_cuda(offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
                  halo: int = 0) -> torch.Tensor:
    """K2 on the card: one launch on the current stream, no sync."""
    global kernel_launches, halo_launches
    n = _check(offsets, data, x, halo)
    if data.device.type != "cuda":
        raise ValueError(f"K2 needs CUDA tensors, got {data.device}")
    form = (data.dtype, x.dtype)
    if form not in _C_FUNCS:
        raise TypeError(f"K2 takes float32 or float64 data, or bfloat16 "
                        f"data with float32 or float64 x; got {data.dtype}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("K2 needs contiguous data and x")
    fn = _kernel_fn(form)
    y = torch.empty((n,), dtype=x.dtype, device=x.device)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), x.data_ptr(), y.data_ptr(), len(offsets), n,
                halo, offs, stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    kernel_launches += 1
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
