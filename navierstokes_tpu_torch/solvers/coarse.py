"""Two-level (coarse-grid corrected) preconditioning: the dense branch.

Nodes are aggregated in contiguous equal-size index ranges (spatial blocks
after band ordering).  The Galerkin coarse operator A_c = R A P with a
piecewise-constant-per-component prolongation is inverted densely once per
prepared operator; each preconditioner apply is then a reshape-sum
restriction, one (nc, nc) GEMV and a broadcast prolongation, all on the
component-plane layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def coarse_dense_matrix(cs: CoarseSpace, offsets: tuple, data: torch.Tensor,
                        *, shift: float = 0.0) -> torch.Tensor:
    """Dense A_c = R A P from scalar-DIA data, in the data's dtype: one
    (ndof,) scatter-add per diagonal.  Entries whose column i + d leaves
    the matrix are masked: DIA storage does not guarantee zeros there."""
    K, ndof = data.shape
    nc, agg = cs.nc, cs.agg_size
    i = torch.arange(ndof, device=data.device)
    ic = 4 * ((i // 4) // agg) + (i % 4)
    ac_flat = torch.zeros(nc * nc, dtype=data.dtype, device=data.device)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    for k, d in enumerate(offsets):
        j = i + d
        valid = (j >= 0) & (j < ndof)
        j_cl = j.clamp(0, ndof - 1)
        jc = 4 * ((j_cl // 4) // agg) + (j_cl % 4)
        ac_flat.index_add_(0, ic * nc + jc, torch.where(valid, data[k], zero))
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
    in the working dtype on the data's device."""
    ac = coarse_dense_matrix(cs, offsets, data, shift=shift)
    inv = np.linalg.inv(ac.cpu().numpy().astype(np.float64))
    return torch.as_tensor(inv, device=data.device).to(data.dtype)
