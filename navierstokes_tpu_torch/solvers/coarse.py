"""Two-level (coarse-grid corrected) preconditioning.

Nodes are aggregated in contiguous equal-size index ranges (spatial blocks
after band ordering).  The Galerkin coarse operator A_c = R A P with a
piecewise-constant-per-component prolongation is either inverted densely
once per prepared operator (each apply is then a reshape-sum restriction,
one (nc, nc) GEMV and a broadcast prolongation), or, when nc exceeds
`coarse_dense_max`, kept sparse in scalar-DIA form (`coarse_operator_dia`)
and solved by a two-grid cycle one level down (the multilevel path).
Restriction and prolongation exist for the component-plane layout of
n components (`*_planes`: 4 on 'tlp', 3 and 1 for the Schur tier's
velocity and pressure cycles) and for interleaved vectors (`restrict`,
`prolong`).  The host helpers of the dense coarse matrices
(`agg_diag_add`, `node_block_view`, `pin_inert`) serve this module and
the Schur tier's algebra (`solvers/schur.py`) alike.

Two variants of the dense coarse level, both built on the host in float64:
the per-aggregate linear basis {1, x, y, z} (`build_linear_weights`,
`linear_coarse_inverse_dia`, `*_planes_linear`: 16 coarse DoF per
aggregate, the plane layout only) and smoothed aggregation, the
Petrov-Galerkin product of P = (I - omega D^{-1}A) P0 and R = P0^T
(`smoothed_coarse_inverse_dia`; the model applies P on the fly).  The
block-CSR form `coarse_operator_inverse` serves the host oracles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.ops.plane_dia import node_offsets_from_scalar
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


def _check_planes(cs: CoarseSpace, nbp: int) -> None:
    if cs.nb_pad > nbp:
        raise ValueError(f"aggregation padding {cs.nb_pad} exceeds the plane "
                         f"layout's nbp={nbp}")


def restrict_planes(cs: CoarseSpace, rp: torch.Tensor, nbp: int,
                    n_comp: int) -> torch.Tensor:
    """R r: plane-major padded (n_comp * nbp,) -> coarse (n_comp * n_agg,),
    aggregate-major then component (the order of the dense coarse
    inverses; n_comp = 4 gives the interleaved order of `restrict`).

    Rows nb..nbp of the plane vectors are zero throughout the solve, so the
    aggregation padding (nb..nb_pad) adds nothing."""
    _check_planes(cs, nbp)
    r2 = rp.reshape(n_comp, nbp)[:, :cs.nb_pad]
    rc = r2.reshape(n_comp, cs.n_agg, cs.agg_size).sum(-1)
    return rc.T.reshape(-1)


def prolong_planes(cs: CoarseSpace, zc: torch.Tensor, nbp: int, nb: int,
                   n_comp: int) -> torch.Tensor:
    """P zc: coarse (n_comp * n_agg,) -> plane-major padded (n_comp * nbp,),
    with the padding rows nb..nbp kept at exact zero."""
    _check_planes(cs, nbp)
    z2 = zc.reshape(cs.n_agg, n_comp).T
    out = torch.zeros((n_comp, nbp), dtype=zc.dtype, device=zc.device)
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


def build_linear_weights(cs: CoarseSpace, coords: np.ndarray) -> np.ndarray:
    """(4, nb_pad) per-aggregate orthonormal linear basis weight planes.

    Mode m's weight on node i is Q[i//agg][i%agg, m], with Q the
    per-aggregate QR orthonormalization of [1, x - x_bar, y - y_bar,
    z - z_bar] over the aggregate's nodes (coordinates in operator row
    order).  Padding rows (>= nb) and rank-deficient modes (degenerate
    aggregate geometry, or fewer than 4 nodes) carry zero weight; the
    Galerkin builder pins their coarse diagonal."""
    nb, agg, n_agg, nb_pad = cs.nb, cs.agg_size, cs.n_agg, cs.nb_pad
    M = np.zeros((nb_pad, 4))
    M[:nb, 0] = 1.0
    M[:nb, 1:] = np.asarray(coords, dtype=np.float64)[:nb]
    M = M.reshape(n_agg, agg, 4)
    cnt = np.maximum(M[:, :, 0].sum(1), 1.0)
    for d in range(1, 4):
        mean = M[:, :, d].sum(1) / cnt
        M[:, :, d] -= mean[:, None]
        M[:, :, d] *= M[:, :, 0]           # re-zero padding rows
    Q, R = np.linalg.qr(M)                 # batched reduced: min(agg, 4) cols
    rd = np.abs(np.diagonal(R, axis1=1, axis2=2))
    bad = rd < 1e-10 * np.maximum(rd.max(1, keepdims=True), 1e-300)
    Q = np.where(bad[:, None, :], 0.0, Q)
    if Q.shape[2] < 4:                     # the missing modes are inert
        Q = np.concatenate([Q, np.zeros((n_agg, agg, 4 - Q.shape[2]))],
                           axis=2)
    return np.ascontiguousarray(Q.transpose(2, 0, 1).reshape(4, nb_pad))


def pin_inert(out: np.ndarray, shift: float) -> np.ndarray:
    """Pin the diagonal of inert coarse DoF (zero weight columns, padding
    aggregates, aggregates of constrained rows only) so the inverse exists
    (their restricted residual is zero, so they add no correction), then
    add the shift."""
    nc = out.shape[0]
    out[np.diag_indices(nc)] += np.where(np.abs(np.diagonal(out)) <= 1e-300,
                                         1.0, 0.0)
    if shift:
        out[np.diag_indices(nc)] += shift
    return out


def agg_diag_add(ac_flat: np.ndarray, v: np.ndarray, node_off: int, a: int,
                 c: int, n_agg: int, agg: int, nc: int, dof: int = 4) -> None:
    """Add one node diagonal into a dense coarse matrix (flat, in place).

    `v[i]` (a node index; length n_agg * agg, padding rows zero)
    contributes to A_c[dof*(i//agg) + a, dof*((i+node_off)//agg) + c].  For
    a fixed node_off, (i + node_off)//agg = i//agg + q with q taking two
    values split by the phase i % agg, so each (q, a, c) lands on one
    strided diagonal of the dense matrix: two vectorized adds."""
    q0, dm = divmod(int(node_off), agg)
    t = agg - dm
    V = v.reshape(n_agg, agg)
    ic = np.arange(n_agg)
    for q, s in ((q0, V[:, :t].sum(1, dtype=np.float64)),
                 (q0 + 1, V[:, t:].sum(1, dtype=np.float64) if dm else None)):
        if s is None:
            continue
        sel = (ic + q >= 0) & (ic + q < n_agg)
        idx = (dof * ic[sel] + a) * nc + dof * (ic[sel] + q) + c
        ac_flat[idx] += s[sel]


def node_block_view(offsets: tuple, dd: np.ndarray, nb: int,
                    node_offsets: tuple) -> np.ndarray:
    """(N_D, nb, 4, 4) block view of scalar-DIA data:
    A_blk[iD, i, a, b] = A[4i+a, 4(i+D)+b].  Absent scalar diagonals give
    zero blocks, and rows whose column node i + D leaves the matrix are
    zeroed (DIA storage does not guarantee zeros there)."""
    kidx = {k: i for i, k in enumerate(offsets)}
    A_blk = np.zeros((len(node_offsets), nb, 4, 4), dtype=dd.dtype)
    for iD, D in enumerate(node_offsets):
        for a in range(4):
            for b in range(4):
                k = 4 * D + (b - a)
                if k in kidx:
                    A_blk[iD, :, a, b] = dd[kidx[k], a::4]
        if D < 0:
            A_blk[iD, :-D] = 0.0
        elif D > 0:
            A_blk[iD, nb - D:] = 0.0
    return A_blk


def _host_blocks(offsets: tuple, data: torch.Tensor, nb: int) -> tuple:
    """(node offsets, the (N_D, nb, 4, 4) block view) of DIA data, on the
    host in the data's dtype."""
    noffs = node_offsets_from_scalar(offsets)
    return noffs, node_block_view(offsets, data.cpu().numpy(), nb, noffs)


def linear_coarse_dense_matrix(cs: CoarseSpace, offsets: tuple,
                               dia_data: torch.Tensor, w: np.ndarray, *,
                               shift: float = 0.0) -> np.ndarray:
    """Dense Galerkin A_c = P^T A P (host, float64) for the linear basis:
    P[4i+a, 16 g + 4 m + a] = w[m, i] for g = i//agg, so the coarse DoF are
    aggregate-major, then mode, then component.  For each node offset D
    and mode pair (m, m'), the weighted block plane w[m, i] A_blk[D, i, a,
    b] w[m', i+D] goes onto coarse diagonals (`agg_diag_add`, dof=16)."""
    nb, agg, n_agg = cs.nb, cs.agg_size, cs.n_agg
    nc = 16 * n_agg
    noffs, A_blk = _host_blocks(offsets, dia_data, nb)
    wf = np.asarray(w, dtype=np.float64)
    ac = np.zeros(nc * nc, dtype=np.float64)
    vbuf = np.zeros(cs.nb_pad, dtype=np.float64)
    for iD, D in enumerate(noffs):
        lo, hi = max(0, -D), nb - max(0, D)
        if hi <= lo:
            continue
        blk = A_blk[iD, lo:hi].astype(np.float64)
        for m in range(4):
            for mp in range(4):
                M2 = blk * (wf[m, lo:hi, None, None]
                            * wf[mp, lo + D:hi + D, None, None])
                for a in range(4):
                    for b in range(4):
                        vbuf[:] = 0.0
                        vbuf[lo:hi] = M2[:, a, b]
                        agg_diag_add(ac, vbuf, D, 4 * m + a, 4 * mp + b,
                                     n_agg, agg, nc, dof=16)
    return pin_inert(ac.reshape(nc, nc), shift)


def linear_coarse_inverse_dia(cs: CoarseSpace, offsets: tuple,
                              dia_data: torch.Tensor, w: np.ndarray, *,
                              shift: float = 0.0) -> torch.Tensor:
    """The host float64 inverse of the linear-basis coarse matrix, in the
    data's dtype on its device."""
    ac = linear_coarse_dense_matrix(cs, offsets, dia_data, w, shift=shift)
    return torch.as_tensor(np.linalg.inv(ac)).to(dia_data.device,
                                                  dia_data.dtype)


def restrict_planes_linear(cs: CoarseSpace, rp: torch.Tensor, nbp: int,
                           w: torch.Tensor) -> torch.Tensor:
    """P^T r on a plane-major padded fine vector -> (16 n_agg,) coarse, in
    the order of `linear_coarse_dense_matrix`."""
    _check_planes(cs, nbp)
    r3 = rp.reshape(4, nbp)[:, :cs.nb_pad].reshape(4, cs.n_agg, cs.agg_size)
    w3 = w.reshape(4, cs.n_agg, cs.agg_size)
    return torch.einsum("cgp,mgp->gmc", r3, w3).reshape(-1)


def prolong_planes_linear(cs: CoarseSpace, zc: torch.Tensor, nbp: int,
                          nb: int, w: torch.Tensor) -> torch.Tensor:
    """P zc: (16 n_agg,) coarse -> plane-major padded fine vector, with the
    padding rows nb..nbp kept at exact zero."""
    _check_planes(cs, nbp)
    zf = torch.einsum("gmc,mgp->cgp", zc.reshape(cs.n_agg, 4, 4),
                      w.reshape(4, cs.n_agg, cs.agg_size))
    out = torch.zeros((4, nbp), dtype=zc.dtype, device=zc.device)
    out[:, :nb] = zf.reshape(4, cs.nb_pad)[:, :nb]
    return out.reshape(-1)


def smoothed_coarse_dense_matrix(cs: CoarseSpace, offsets: tuple,
                                 dia_data: torch.Tensor,
                                 inv_diag: torch.Tensor, *, omega: float,
                                 shift: float = 0.0) -> np.ndarray:
    """Dense Petrov-Galerkin coarse matrix (host, float64) of smoothed
    aggregation:

        P = (I - omega D^{-1} A) P0,   R = P0^T
        A_c = P0^T A P0 - omega P0^T (A D^{-1} A) P0

    On the node-block band, A D^{-1} A regroups as N_D^2 batched 4x4 block
    products, each added onto coarse diagonals.  The JAX package measured
    it worse than plain aggregation on this indefinite operator (3x the
    iterations in float64 at matrix 3, no convergence at 117k rows, for
    every omega in {0.5, 0.6667, 1.0}); it is kept for parity."""
    nb, agg, n_agg, nc = cs.nb, cs.agg_size, cs.n_agg, cs.nc
    noffs, A_blk = _host_blocks(offsets, dia_data, nb)
    di = inv_diag.cpu().numpy()
    C_blk = np.matmul(di[None], A_blk)                 # D^{-1} A, per offset
    ac = np.zeros(nc * nc, dtype=np.float64)
    vbuf = np.zeros(cs.nb_pad, dtype=np.float64)
    for iD, D in enumerate(noffs):                     # P0^T A P0
        for a in range(4):
            for c in range(4):
                vbuf[:nb] = A_blk[iD, :, a, c]
                agg_diag_add(ac, vbuf, D, a, c, n_agg, agg, nc)
    ac1 = np.zeros(nc * nc, dtype=np.float64)
    for iD1, D1 in enumerate(noffs):                   # P0^T (A D^-1 A) P0
        lo, hi = max(0, -D1), nb - max(0, D1)
        if hi <= lo:
            continue
        A1 = A_blk[iD1, lo:hi]
        for iD2, D2 in enumerate(noffs):
            M = np.matmul(A1, C_blk[iD2, lo + D1:hi + D1])
            for a in range(4):
                for c in range(4):
                    vbuf[:] = 0.0
                    vbuf[lo:hi] = M[:, a, c]
                    agg_diag_add(ac1, vbuf, D1 + D2, a, c, n_agg, agg, nc)
    out = (ac - omega * ac1).reshape(nc, nc)
    if shift:
        out[np.diag_indices(nc)] += shift
    return out


def smoothed_coarse_inverse_dia(cs: CoarseSpace, offsets: tuple,
                                dia_data: torch.Tensor,
                                inv_diag: torch.Tensor, *, omega: float,
                                shift: float = 0.0) -> torch.Tensor:
    """The host float64 inverse of the smoothed-aggregation coarse matrix,
    in the data's dtype on its device."""
    ac = smoothed_coarse_dense_matrix(cs, offsets, dia_data, inv_diag,
                                      omega=omega, shift=shift)
    return torch.as_tensor(np.linalg.inv(ac)).to(dia_data.device,
                                                  dia_data.dtype)


def coarse_operator_inverse(cs: CoarseSpace, bcsr_values: torch.Tensor,
                            row_ids, col_indices, *,
                            shift: float = 0.0) -> torch.Tensor:
    """Dense inverse of A_c = R A P from block-CSR values (nnzb, 4, 4) and
    their block coordinates; `shift` regularizes the coarse pressure
    block.  A_c is added in a fixed order and inverted in the values'
    dtype, as in the JAX package."""
    nc = cs.nc
    dev = bcsr_values.device
    agg_i = torch.as_tensor(np.asarray(row_ids) // cs.agg_size,
                            dtype=torch.int64, device=dev)
    agg_j = torch.as_tensor(np.asarray(col_indices) // cs.agg_size,
                            dtype=torch.int64, device=dev)
    a4 = torch.arange(4, device=dev)
    rows = (4 * agg_i)[:, None, None] + a4[None, :, None]
    cols = (4 * agg_j)[:, None, None] + a4[None, None, :]
    flat = torch.zeros(nc * nc, dtype=bcsr_values.dtype, device=dev)
    index_add_fixed_order(flat, (rows * nc + cols).reshape(-1),
                          bcsr_values.reshape(-1))
    ac = flat.reshape(nc, nc)
    if shift:
        ac = ac + shift * torch.eye(nc, dtype=ac.dtype, device=dev)
    return torch.linalg.inv(ac)
