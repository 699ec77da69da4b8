"""Two-level (coarse-grid corrected) preconditioning.

Nodes are aggregated in contiguous equal-size index ranges (spatial blocks
after band ordering).  The Galerkin coarse operator A_c = R A P with a
piecewise-constant-per-component prolongation is either inverted densely
once per prepared operator (each apply is then a reshape-sum restriction,
one (nc, nc) GEMV and a broadcast prolongation), or, when nc exceeds
`coarse_dense_max`, kept sparse in scalar-DIA form (`coarse_operator_dia`)
and solved by a two-grid cycle one level down (the multilevel path).
Restriction and prolongation exist for the component-plane layout
(`*_planes`) and for interleaved vectors (`restrict`, `prolong`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.ops.scatter import index_add_fixed_order


@dataclasses.dataclass
class CoarseSpace:
    """Static aggregation data: node i belongs to aggregate i // agg_size."""

    n_agg: int
    agg_size: int
    nb: int

    @property
    def nc(self) -> int:
        return 4 * self.n_agg

    @property
    def nb_pad(self) -> int:
        return self.n_agg * self.agg_size


def build_aggregates(nb: int, agg_size: int = 64) -> CoarseSpace:
    return CoarseSpace(n_agg=-(-nb // agg_size) if nb else 0,
                       agg_size=agg_size, nb=nb)


def restrict(cs: CoarseSpace, r: torch.Tensor) -> torch.Tensor:
    """R r: the per-component sum over each aggregate of an interleaved
    (4*nb,) vector -> interleaved coarse (nc,)."""
    r2 = torch.nn.functional.pad(r, (0, 4 * (cs.nb_pad - cs.nb)))
    return r2.reshape(cs.n_agg, cs.agg_size, 4).sum(1).reshape(-1)


def prolong(cs: CoarseSpace, rc: torch.Tensor) -> torch.Tensor:
    """P rc = R^T rc: each aggregate's value broadcast back to its nodes,
    (nc,) -> (4*nb,)."""
    zf = rc.reshape(cs.n_agg, 1, 4).expand(cs.n_agg, cs.agg_size, 4)
    return zf.reshape(-1)[:4 * cs.nb]


def restrict_planes(cs: CoarseSpace, rp: torch.Tensor,
                    nbp: int) -> torch.Tensor:
    """R r on a plane-major padded fine vector -> interleaved coarse (nc,).

    Rows nb..nbp of the plane vectors are zero throughout the solve, so the
    aggregation padding (nb..nb_pad) adds nothing."""
    if cs.nb_pad > nbp:
        raise ValueError(f"aggregation padding {cs.nb_pad} exceeds the plane "
                         f"layout's nbp={nbp}")
    r2 = rp.reshape(4, nbp)[:, :cs.nb_pad]
    rc = r2.reshape(4, cs.n_agg, cs.agg_size).sum(-1)     # (4, n_agg)
    return rc.T.reshape(-1)


def prolong_planes(cs: CoarseSpace, zc: torch.Tensor, nbp: int,
                   nb: int) -> torch.Tensor:
    """P zc: interleaved coarse (nc,) -> plane-major padded fine vector,
    with the padding rows nb..nbp kept at exact zero."""
    if cs.nb_pad > nbp:
        raise ValueError(f"aggregation padding {cs.nb_pad} exceeds the plane "
                         f"layout's nbp={nbp}")
    z2 = zc.reshape(cs.n_agg, 4).T                        # (4, n_agg)
    out = torch.zeros((4, nbp), dtype=zc.dtype, device=zc.device)
    out[:, :nb] = z2.repeat_interleave(cs.agg_size, dim=1)[:, :nb]
    return out.reshape(-1)


def _coarse_index(i: torch.Tensor, agg: int) -> torch.Tensor:
    """Scalar fine index -> scalar coarse index 4 * aggregate + component."""
    return 4 * ((i // 4) // agg) + (i % 4)


def coarse_dia_offsets(offsets: tuple, agg: int) -> tuple:
    """The coarse level's DIA offsets under contiguous aggregation.

    The index map ic = 4*((i//4)//agg) + i%4 is periodic in i with period
    L = 4*agg (shifting i by L shifts ic by 4), so one interior period
    yields every offset jc - ic that a fine entry can produce."""
    L = 4 * agg
    h = max(abs(d) for d in offsets)
    base = (h // L + 1) * L                    # interior: j = i + d >= 0
    out = set()
    for r in range(L):
        i = base + r
        ic = 4 * ((i // 4) // agg) + i % 4
        for d in offsets:
            j = i + d
            out.add(4 * ((j // 4) // agg) + j % 4 - ic)
    return tuple(sorted(out))


def coarse_operator_dia(cs: CoarseSpace, offsets: tuple, data: torch.Tensor,
                        coarse_offsets: tuple, *,
                        shift: float = 0.0) -> torch.Tensor:
    """The Galerkin coarse operator A_c = R A P in scalar-DIA form, (Kc, nc)
    with Kc = len(coarse_offsets): one (ndof,) scatter-add per fine
    diagonal.  Entries whose column leaves the matrix are masked."""
    K, ndof = data.shape
    nc = cs.nc
    co = torch.as_tensor(coarse_offsets, device=data.device)
    i = torch.arange(ndof, device=data.device)
    ic = _coarse_index(i, cs.agg_size)
    flat = torch.zeros(len(coarse_offsets) * nc, dtype=data.dtype,
                       device=data.device)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    for k, d in enumerate(offsets):
        j = i + d
        valid = (j >= 0) & (j < ndof)
        jc = _coarse_index(j.clamp(0, ndof - 1), cs.agg_size)
        kc = torch.searchsorted(co, jc - ic).clamp_(max=len(co) - 1)
        # an invalid entry adds 0 wherever its (clamped) slot lands
        index_add_fixed_order(flat, kc * nc + ic,
                              torch.where(valid, data[k], zero))
    ac = flat.reshape(len(coarse_offsets), nc)
    if shift:
        ac[coarse_offsets.index(0)] += shift
    return ac


def coarse_dense_matrix(cs: CoarseSpace, offsets: tuple, data: torch.Tensor,
                        *, shift: float = 0.0) -> torch.Tensor:
    """Dense A_c = R A P from scalar-DIA data, in the data's dtype: one
    (ndof,) scatter-add per diagonal.  Entries whose column i + d leaves
    the matrix are masked: DIA storage does not guarantee zeros there."""
    K, ndof = data.shape
    nc = cs.nc
    i = torch.arange(ndof, device=data.device)
    ic = _coarse_index(i, cs.agg_size)
    ac_flat = torch.zeros(nc * nc, dtype=data.dtype, device=data.device)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    for k, d in enumerate(offsets):
        j = i + d
        valid = (j >= 0) & (j < ndof)
        jc = _coarse_index(j.clamp(0, ndof - 1), cs.agg_size)
        index_add_fixed_order(ac_flat, ic * nc + jc,
                              torch.where(valid, data[k], zero))
    ac = ac_flat.reshape(nc, nc)
    if shift:
        ac = ac + shift * torch.eye(nc, dtype=ac.dtype, device=ac.device)
    return ac


def coarse_operator_inverse_dia(cs: CoarseSpace, offsets: tuple,
                                data: torch.Tensor, *,
                                shift: float = 0.0) -> torch.Tensor:
    """Dense inverse of A_c, taken on the host in float64 and cast back.

    A_c is built in the working dtype (as the JAX package does), inverted
    in float64 (the saddle-point coarse matrix is ill-conditioned; an f32
    inverse made the iteration counts a lottery on the TPU), and returned
    in the working dtype on the data's device.  The data may be a coarse
    level itself ((Kc, nc) from `coarse_operator_dia`, with `cs` the
    second aggregation level)."""
    ac = coarse_dense_matrix(cs, offsets, data, shift=shift)
    inv = np.linalg.inv(ac.cpu().numpy().astype(np.float64))
    return torch.as_tensor(inv, device=data.device).to(data.dtype)
