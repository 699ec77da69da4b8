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
seed, so both packages build the same numbers.  The device half, the
model's `_schur_operators`, composes the two cycles from `solvers/cycle.py`.
"""

from __future__ import annotations

import numpy as np

from navierstokes_tpu_torch.solvers.coarse import (
    CoarseSpace,
    agg_diag_add,
    node_block_view,
    pin_inert,
)

POWER_SEED = 20260820       # the JAX package's power-iteration seed


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


def velocity_coarse_inverse(cs: CoarseSpace, a_blk: np.ndarray,
                            node_offsets: tuple, *,
                            shift: float = 0.0) -> np.ndarray:
    """Dense inverse of the aggregated velocity block R F P (host float64).
    Piecewise-constant basis, 3 DoF per aggregate, coarse DoFs ordered
    aggregate-major then component (as `coarse.restrict_planes`)."""
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
    return np.linalg.inv(pin_inert(ac.reshape(nc, nc), shift))


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
    return np.linalg.inv(pin_inert(ac.reshape(n_agg, n_agg), shift))


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
