"""Pressure Schur-complement block preconditioning (the 'sch' prep).

The operator has the per-node saddle-point block structure (rows and
columns ordered u, v, w, p):

    A = [ F    B^T ]        F   = M/dt + diffusion (+ convection)
        [ -B   D   ]        B   = divergence, B^T = pressure gradient
                            D   = Brezzi-Pitkaranta stabilization

The preconditioner is block lower-triangular,

    M = [ F_hat    0     ]        z_u = F_hat^{-1} r_u
        [ -B       S_hat ]        z_p = S_hat^{-1} (r_p + B z_u)

with the SIMPLE approximation of the Schur complement
S_hat = D + B diag(F)^{-1} B^T: banded, on the sumset of the node offsets,
assembled on the host in float64 once per operator preparation.  F_hat and
S_hat are two-grid cycles, each a dense aggregation coarse inverse (3 and
1 DoF per aggregate, host float64) and a diagonal-preconditioned smoother
(one Jacobi application or a Chebyshev sweep whose interval comes from a
host power iteration).

The host algebra here is the JAX package's `solvers/schur.py` in numpy,
the same operations in the same order and with the same power-iteration
seed, so both packages build the same numbers.  `restrict_planes_n` and
`prolong_planes_n` act on plane-major torch tensors, on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch.solvers.coarse import CoarseSpace

POWER_SEED = 20260820       # the JAX package's power-iteration seed


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


def split_blocks(offsets: tuple, dia_data: np.ndarray, nb: int,
                 node_offsets: tuple) -> np.ndarray:
    """Host block view (N_D, nb, 4, 4) of the BC-applied operator."""
    return node_block_view(offsets, np.asarray(dia_data), nb, node_offsets)


def diag_f_inverse(a_blk: np.ndarray, node_offsets: tuple) -> np.ndarray:
    """(nb, 3, 3) inverses of the velocity diagonal blocks, float64.

    Constrained velocity rows are identity rows after the BC insert, and
    M/dt keeps the interior blocks well conditioned, so every block is
    nonsingular."""
    i0 = node_offsets.index(0)
    return np.linalg.inv(a_blk[i0, :, :3, :3].astype(np.float64))


def build_schur_dia(a_blk: np.ndarray, node_offsets: tuple, nb: int,
                    fd_inv: np.ndarray):
    """S_hat = A_pp - A_pu diag(F)^{-1} A_up as node-DIA (host float64).

    The signs are the operator's own (A_pu = -B, A_pp = D), so S_hat =
    D + B diag(F)^{-1} B^T.  Returns (s_offsets, s_data) with
    s_data[k][i] = S_hat[i, i + s_offsets[k]]; the band is the sumset
    {d1 + d2} of the node offsets, less the diagonals that come out
    identically zero."""
    sums = sorted({d1 + d2 for d1 in node_offsets for d2 in node_offsets}
                  | set(node_offsets))
    sidx = {d: k for k, d in enumerate(sums)}
    s = np.zeros((len(sums), nb), dtype=np.float64)

    for i_d, d in enumerate(node_offsets):        # A_pp
        s[sidx[d]] += a_blk[i_d, :, 3, 3].astype(np.float64)

    # - A_pu diag(F)^{-1} A_up by node-offset pairs:
    #   S[i, i+d1+d2] -= sum_{c,c'} A_pu[d1][i,c] Fdinv[i+d1][c,c']
    #                                 A_up[d2][i+d1,c']
    for i1, d1 in enumerate(node_offsets):
        lo, hi = max(0, -d1), nb - max(0, d1)
        if hi <= lo:
            continue
        pu = a_blk[i1, lo:hi, 3, :3].astype(np.float64)
        w = np.einsum("ic,icq->iq", pu, fd_inv[lo + d1:hi + d1])
        for i2, d2 in enumerate(node_offsets):
            up = a_blk[i2, lo + d1:hi + d1, :3, 3].astype(np.float64)
            s[sidx[d1 + d2], lo:hi] -= np.einsum("iq,iq->i", w, up)

    keep = [k for k in range(len(sums))
            if sums[k] == 0 or np.any(s[k] != 0.0)]
    return tuple(sums[k] for k in keep), np.ascontiguousarray(s[keep])


def _pin_and_invert(ac: np.ndarray, shift: float) -> np.ndarray:
    """Put 1 on zero diagonal entries (aggregates of constrained rows only),
    add the shift, invert."""
    n = ac.shape[0]
    dg = np.abs(np.diagonal(ac))
    ac[np.diag_indices(n)] += np.where(dg <= 1e-300, 1.0, 0.0)
    if shift:
        ac[np.diag_indices(n)] += shift
    return np.linalg.inv(ac)


def velocity_coarse_inverse(cs: CoarseSpace, a_blk: np.ndarray,
                            node_offsets: tuple, *,
                            shift: float = 0.0) -> np.ndarray:
    """Dense inverse of the aggregated velocity block R F P (host float64).
    Piecewise-constant basis, 3 DoF per aggregate, coarse DoFs ordered
    aggregate-major then component (as `restrict_planes_n`)."""
    nb, agg, n_agg = cs.nb, cs.agg_size, cs.n_agg
    nc = 3 * n_agg
    ac = np.zeros(nc * nc, dtype=np.float64)
    vbuf = np.zeros(cs.nb_pad, dtype=np.float64)
    for i_d, d in enumerate(node_offsets):
        for a in range(3):
            for b in range(3):
                vbuf[:] = 0.0
                vbuf[:nb] = a_blk[i_d, :, a, b]
                agg_diag_add(ac, vbuf, d, a, b, n_agg, agg, nc, dof=3)
    return _pin_and_invert(ac.reshape(nc, nc), shift)


def scalar_coarse_inverse(cs: CoarseSpace, s_offsets: tuple,
                          s_data: np.ndarray, *,
                          shift: float = 0.0) -> np.ndarray:
    """Dense inverse of the aggregated S_hat (1 DoF per aggregate, host
    float64)."""
    nb, agg, n_agg = cs.nb, cs.agg_size, cs.n_agg
    ac = np.zeros(n_agg * n_agg, dtype=np.float64)
    vbuf = np.zeros(cs.nb_pad, dtype=np.float64)
    for k, d in enumerate(s_offsets):
        lo, hi = max(0, -d), nb - max(0, d)
        if hi <= lo:
            continue
        vbuf[:] = 0.0
        vbuf[lo:hi] = s_data[k, lo:hi]
        agg_diag_add(ac, vbuf, d, 0, 0, n_agg, agg, n_agg, dof=1)
    return _pin_and_invert(ac.reshape(n_agg, n_agg), shift)


def _spmv_dia_host(s_offsets: tuple, s_data: np.ndarray,
                   x: np.ndarray) -> np.ndarray:
    y = np.zeros_like(x)
    nb = x.shape[0]
    for k, d in enumerate(s_offsets):
        lo, hi = max(0, -d), nb - max(0, d)
        if hi > lo:
            y[lo:hi] += s_data[k, lo:hi] * x[lo + d:hi + d]
    return y


def _spmv_blocks_host(a_blk: np.ndarray, node_offsets: tuple,
                      x: np.ndarray) -> np.ndarray:
    """y (nb, 3) = F x with F the (:3, :3) sub-blocks of a_blk."""
    nb = x.shape[0]
    y = np.zeros_like(x)
    for i_d, d in enumerate(node_offsets):
        lo, hi = max(0, -d), nb - max(0, d)
        if hi > lo:
            y[lo:hi] += np.einsum(
                "iab,ib->ia", a_blk[i_d, lo:hi, :3, :3].astype(np.float64),
                x[lo + d:hi + d])
    return y


def _power_lmax(apply, x: np.ndarray, iters: int) -> float:
    lam = 1.0
    for _ in range(iters):
        y = apply(x)
        lam = float(np.linalg.norm(y))
        if lam == 0.0:
            return 1.0
        x = y / lam
    return lam


def power_lmax_schur(s_offsets: tuple, s_data: np.ndarray,
                     s_dinv: np.ndarray, iters: int = 40) -> float:
    """|lmax| of diag(S_hat)^{-1} S_hat by host power iteration."""
    x = np.random.default_rng(POWER_SEED).standard_normal(s_data.shape[1])
    return _power_lmax(
        lambda v: s_dinv * _spmv_dia_host(s_offsets, s_data, v), x, iters)


def power_lmax_velocity(a_blk: np.ndarray, node_offsets: tuple,
                        fd_inv: np.ndarray, iters: int = 40) -> float:
    """|lmax| of diag(F)^{-1} F by host power iteration (F is
    nonsymmetric but M/dt-dominated: its dominant eigenvalue is real and
    positive in practice)."""
    nb = a_blk.shape[1]
    x = np.random.default_rng(POWER_SEED).standard_normal((nb, 3))
    return _power_lmax(
        lambda v: np.einsum("icq,iq->ic", fd_inv,
                            _spmv_blocks_host(a_blk, node_offsets, v)),
        x, iters)


# -- plane-layout restriction and prolongation (n_comp components) ----------


def restrict_planes_n(cs: CoarseSpace, rp: torch.Tensor, nbp: int,
                      n_comp: int) -> torch.Tensor:
    """R r: plane-major (n_comp * nbp,) -> coarse (n_comp * n_agg,),
    aggregate-major then component (the order of the dense coarse
    inverses).  Rows nb..nbp of the planes are zero, so the aggregation
    padding adds nothing."""
    if cs.nb_pad > nbp:
        raise ValueError(f"aggregation padding {cs.nb_pad} exceeds the plane "
                         f"layout's nbp={nbp}")
    r2 = rp.reshape(n_comp, nbp)[:, :cs.nb_pad]
    rc = r2.reshape(n_comp, cs.n_agg, cs.agg_size).sum(-1)
    return rc.T.reshape(-1)


def prolong_planes_n(cs: CoarseSpace, zc: torch.Tensor, nbp: int, nb: int,
                     n_comp: int) -> torch.Tensor:
    """P zc: coarse (n_comp * n_agg,) -> plane-major (n_comp * nbp,), the
    padding rows nb..nbp at exact zero."""
    if cs.nb_pad > nbp:
        raise ValueError(f"aggregation padding {cs.nb_pad} exceeds the plane "
                         f"layout's nbp={nbp}")
    z2 = zc.reshape(cs.n_agg, n_comp).T
    out = torch.zeros((n_comp, nbp), dtype=zc.dtype, device=zc.device)
    out[:, :nb] = z2.repeat_interleave(cs.agg_size, dim=1)[:, :nb]
    return out.reshape(-1)
