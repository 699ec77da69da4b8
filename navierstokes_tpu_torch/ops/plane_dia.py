"""Component-plane DIA SpMV: the operator layout of the flagship path.

With vectors stored as contiguous component planes (u | v | w | p, each of
nbp nodes), the 4x4-blocked FEM operator becomes n_out x n_in plane
couplings, each a band over the N_D node offsets D:

    y_a[i] = sum_{b, D}  V[a, j(b, D)][i] * x_b[i + D]

with j(b, D) = iD * n_in + b (`plane_terms`).  The operator is stored as
(n_out, n_in * N_D, nbp) planes; rows nb <= i < nbp are padding and hold
zeros.  `spmv_planes` applies it through the CUDA kernel K1
(`csrc/plane_dia.cu`) for tensors on the card, and through the plain
PyTorch version `spmv_planes_plain` for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from navierstokes_tpu_torch.ops import cuda_lib

PAD = 128   # nbp granularity: whole 128-thread kernel blocks, aligned rows

# Plain integer counters: K1 launches, and calls of the plain version.
kernel_launches = 0
plain_calls = 0


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


def node_offsets_from_scalar(offsets: tuple) -> tuple:
    """Block (node) offsets D from the scalar-DIA offset set.

    A 4x4 block at node offset D always populates scalar diagonal 4D, and
    4D is in the scalar set only through a real block offset.  Every scalar
    diagonal must be covered by some block offset (dense node blocks)."""
    ks = set(offsets)
    cands = tuple(sorted(d for d in range(min(offsets) // 4 - 1,
                                          max(offsets) // 4 + 2)
                         if 4 * d in ks))
    cover = {4 * d + e for d in cands for e in range(-3, 4)}
    missing = ks - cover
    if missing:
        raise ValueError(f"scalar diagonals {sorted(missing)} not covered "
                         "by any node offset (non-dense blocks?)")
    return cands


def plane_terms(node_offsets: tuple, n_in: int = 4) -> tuple:
    """Static term list [(b, D), ...] shared by all output planes."""
    return tuple((b, d) for d in node_offsets for b in range(n_in))


def plane_nbp(nb: int, nb_pad: int = 0) -> int:
    """Padded node count of the plane layout: at least the live nodes and
    the aggregation padding `n_agg * agg`, rounded up to `PAD`."""
    n = max(nb, nb_pad, 1)
    return -(-n // PAD) * PAD


def extract_planes(offsets: tuple, data: torch.Tensor, nb: int,
                   node_offsets=None, nbp=None) -> torch.Tensor:
    """Scalar-DIA (K, 4*nb) data -> plane data (4, NT, nb), or (4, NT, nbp)
    zero-padded when `nbp` is given.

    planes[a, j] with terms[j] = (b, D) holds A[4i+a, 4(i+D)+b] for each
    node row i: scalar diagonal k = 4D + (b - a), rows 4i + a (the stride-4
    slice data[k][a::4]).  Diagonals absent from the set are zero planes."""
    if node_offsets is None:
        node_offsets = node_offsets_from_scalar(offsets)
    terms = plane_terms(node_offsets)
    kidx = {k: i for i, k in enumerate(offsets)}
    width = nb if nbp is None else nbp
    planes = torch.zeros((4, len(terms), width), dtype=data.dtype,
                         device=data.device)
    for a in range(4):
        for j, (b, d) in enumerate(terms):
            k = 4 * d + (b - a)
            if k in kidx:
                planes[a, j, :nb] = data[kidx[k], a::4]
    return planes


def to_planes(x: torch.Tensor, nb: int, nbp: int) -> torch.Tensor:
    """Interleaved (4*nb,) -> flat plane-major (4*nbp,) (zero-padded)."""
    out = torch.zeros((4, nbp), dtype=x.dtype, device=x.device)
    out[:, :nb] = x.reshape(nb, 4).T
    return out.reshape(-1)


def from_planes(xp: torch.Tensor, nb: int, nbp: int) -> torch.Tensor:
    """Flat plane-major (4*nbp,) -> interleaved (4*nb,)."""
    return xp.reshape(4, nbp)[:, :nb].T.reshape(-1)


def _check(node_offsets, data: torch.Tensor, x: torch.Tensor, n_in: int,
           nb: int):
    if data.dim() != 3:
        raise ValueError(f"plane data must be (n_out, NT, nbp), got "
                         f"{tuple(data.shape)}")
    n_out, nt, nbp = data.shape
    if not (1 <= n_out <= 4 and 1 <= n_in <= 4):
        raise ValueError(f"n_out={n_out}, n_in={n_in}: both must be in 1..4")
    if not 1 <= len(node_offsets) <= 32:
        raise ValueError(f"{len(node_offsets)} node offsets; K1 takes 1..32")
    if nt != n_in * len(node_offsets):
        raise ValueError(f"NT={nt} != n_in * N_D = {n_in * len(node_offsets)}")
    if x.shape != (n_in * nbp,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({n_in * nbp},)")
    if not 0 <= nb <= nbp:
        raise ValueError(f"nb={nb} outside [0, nbp={nbp}]")
    if data.dtype != x.dtype:
        raise TypeError(f"dtype mismatch: data {data.dtype}, x {x.dtype}")
    if data.device != x.device:
        raise ValueError(f"device mismatch: data {data.device}, x {x.device}")
    return n_out, nbp


def spmv_planes_plain(node_offsets: tuple, data: torch.Tensor,
                      x: torch.Tensor, *, n_in: int, nb: int) -> torch.Tensor:
    """Plain PyTorch K1: the loop of shifted-slice multiply-adds.

    Same terms in the same order as the kernel; x_b[i + D] counts as zero
    outside [0, nbp) and rows >= nb come out as exact zeros."""
    global plain_calls
    n_out, nbp = _check(node_offsets, data, x, n_in, nb)
    plain_calls += 1
    acc_dtype = torch.promote_types(data.dtype, torch.float32)
    xs = x.reshape(n_in, nbp).to(acc_dtype)
    y = torch.zeros((n_out, nbp), dtype=acc_dtype, device=x.device)
    j = 0
    for d in node_offsets:
        lo, hi = max(0, -d), min(nbp, nbp - d)
        for b in range(n_in):
            if hi > lo:
                y[:, lo:hi] += data[:, j, lo:hi].to(acc_dtype) \
                    * xs[b, lo + d:hi + d]
            j += 1
    y[:, nb:] = 0
    return y.to(x.dtype).reshape(-1)


_C_FUNCS = {torch.float32: "plane_spmv_f32", torch.float64: "plane_spmv_f64"}


@functools.cache
def _kernel_fn(dtype: torch.dtype):
    """The C entry point of K1 for `dtype`, built and typed on first use."""
    lib, _ = cuda_lib.load("plane_dia")
    fn = getattr(lib, _C_FUNCS[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmv_planes_cuda(node_offsets: tuple, data: torch.Tensor,
                     x: torch.Tensor, *, n_in: int, nb: int) -> torch.Tensor:
    """K1 on the card: one launch on the current stream, no sync."""
    global kernel_launches
    n_out, nbp = _check(node_offsets, data, x, n_in, nb)
    if data.device.type != "cuda":
        raise ValueError(f"K1 needs CUDA tensors, got {data.device}")
    if data.dtype not in _C_FUNCS:
        raise TypeError(f"K1 takes float32 or float64, got {data.dtype}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("K1 needs contiguous data and x")
    fn = _kernel_fn(data.dtype)
    y = torch.empty((n_out * nbp,), dtype=x.dtype, device=x.device)
    offs = (ctypes.c_int * len(node_offsets))(*node_offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), x.data_ptr(), y.data_ptr(), n_out, n_in,
                len(node_offsets), nb, nbp, offs, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    kernel_launches += 1
    return y


def spmv_planes(node_offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
                n_in: int, nb: int) -> torch.Tensor:
    """y = A x for an n_out x n_in plane-coupling operator.

    The counterpart of the JAX package's `spmv_planes_pallas`: data
    (n_out, n_in * N_D, nbp), term order `plane_terms(node_offsets, n_in)`,
    x flat plane-major (n_in * nbp,), returns (n_out * nbp,).  A CUDA
    tensor goes through K1 (or raises); a CPU tensor through the plain
    version."""
    if x.device.type == "cpu":
        return spmv_planes_plain(node_offsets, data, x, n_in=n_in, nb=nb)
    return spmv_planes_cuda(node_offsets, data, x, n_in=n_in, nb=nb)


def spmv_plane(node_offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
               nb: int) -> torch.Tensor:
    """The flagship 4x4 form of `spmv_planes` (`spmv_plane_pallas`)."""
    return spmv_planes(node_offsets, data, x, n_in=4, nb=nb)
