"""Restarted GMRES(m): the KSPGMRES equivalent, as a Python loop.

Semantics of the JAX package's `solvers/gmres.py`: left preconditioning,
CGS2 (classical Gram–Schmidt, twice) against the live basis rows 0..k,
Givens-rotation least squares, convergence when
the preconditioned residual drops below max(rtol * ||r0||, atol) (PETSc
`KSPConvergedDefault`), restart length m, a total-iteration cap, the
relative breakdown guard and the stall exit.

The projection is four torch GEMVs on the live rows (`cgs2='xla'`) or, with
`cgs2_kernel=True` (`cgs2='pallas'|'pallas_comp'`), one call of the fused
projection `ops/cgs2.cgs2_project` (kernel K3 on the card), for any n.

The Krylov vectors stay on the device: one tensor, or the shards of the
distributed solver (`solvers/vectors.py`; K3 takes one tensor only).  Each
inner iteration reads the new Hessenberg column (k+2 numbers) in one host
wait; the rotations, the tolerance tests and the small triangular solve run
on the host, in numpy scalars of the working dtype so that float32 rounds
as it does on the device.  Every host wait goes through `utils/profiling`
(`fetch`, or `wait` for a graphed iteration's column): one before the first
cycle, one per cycle, one per iteration.

The device part of an inner iteration (`arnoldi_step`: the operator, the
projection, the norm and the new basis row) runs eagerly, kernel by kernel,
or, given `graphs` (`solvers/graphs.IterationGraphs`, which the solver
passes for a plain GMRES solve of its held Newton operator on a CUDA
device), as one CUDA graph per basis index k, captured the first time
iteration k is reached and replayed after: the same kernels, the same
answers bit for bit, one launch.  The basis is then the graphs' persistent
one, and the host reads column k while graph k+1 already runs; a cycle's
end discards that replay (`IterationGraphs.column`, `end_cycle`).

The spans (on only where `utils/profiling` is enabled): `gmres.restart` (a
cycle's residual and its read), `gmres.iter` (one inner iteration; its self
time is the host's Givens work), `gmres.orth` (the projection, the norm and
the new basis row, where they run eagerly), `gmres.replay` (a replayed
iteration's graph launch) and `gmres.update` (the cycle's update of x).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from navierstokes_tpu_torch.ops.cgs2 import cgs2_project
from navierstokes_tpu_torch.solvers import vectors as vs
from navierstokes_tpu_torch.utils.profiling import fetch, span


class GMRESResult(NamedTuple):
    x: torch.Tensor
    iters: int          # total inner iterations performed
    resnorm: float      # final preconditioned residual norm (estimate)
    converged: bool


def _identity(x):
    return x


def scalar_type(dtype: torch.dtype):
    """The numpy scalar type of a torch float dtype (float32 -> np.float32)."""
    return np.dtype(str(dtype).removeprefix("torch.")).type


def _back_substitute(R: np.ndarray, g: np.ndarray, k: int) -> np.ndarray:
    """Solve the upper-triangular R[:k, :k] y = g[:k] in R's dtype."""
    y = np.zeros(R.shape[0], dtype=R.dtype)
    for i in range(k - 1, -1, -1):
        y[i] = (g[i] - R[i, i + 1:k] @ y[i + 1:k]) / R[i, i]
    return y


def arnoldi_step(matvec: Callable, precond: Callable, V, k: int,
                 one: torch.Tensor, cgs2_kernel: bool = False,
                 cgs2_compensated: bool = False) -> tuple:
    """The device part of inner iteration k: w = precond(matvec(V[k])),
    projected against V[:k+1]; V[k+1] = w / ||w||.  Returns (h, ||w||) on
    the device."""
    w = precond(matvec(V[k]))
    with span("gmres.orth"):
        if cgs2_kernel:
            w, hf = cgs2_project(V, w, k, compensated=cgs2_compensated)
            h_t = hf[:k + 1]
        else:
            w, h_t = vs.cgs2(V, w, k)
        hk1_t = vs.norm(w)
        vs.divide_into(V[k + 1], w, torch.where(hk1_t > 0, hk1_t, one))
    return h_t, hk1_t


def gmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    precond: Optional[Callable] = None,
    restart: int = 30,
    rtol: float = 1e-10,
    atol: float = 1e-12,
    maxiter: int = 2000,
    cgs2_kernel: bool = False,
    cgs2_compensated: bool = False,
    graphs=None,
) -> GMRESResult:
    """cgs2_kernel=True orthogonalizes through the fused projection (K3 on
    the card), cgs2_compensated with its compensated h sums.  `graphs`
    (an `IterationGraphs` that `fits` b and `restart`) runs each inner
    iteration's device part as its CUDA graph."""
    if cgs2_kernel and isinstance(b, vs.Shards):
        raise ValueError("the fused CGS2 projection (K3) takes one vector: "
                         "its inner products cannot be summed across shards")
    if graphs is not None and (cgs2_kernel or not graphs.fits(b, restart)):
        raise ValueError("the iteration graphs take the four-GEMV CGS2 and "
                         "a solve of their own vector shape and restart")
    dtype, device = b.dtype, b.device
    sc = scalar_type(dtype)
    eps4 = sc(4.0) * np.finfo(sc).eps
    tiny = sc(1e-300)            # rounds to 0 in float32, as in JAX
    m = restart
    M = precond or _identity
    x = vs.zeros_like(b) if x0 is None else x0.clone()
    one = torch.ones((), dtype=dtype, device=device)

    def pre_residual(x):
        return M(b - matvec(x))

    with span("gmres.restart"):
        r = pre_residual(x)
        beta_t = vs.norm(r)
        beta0 = sc(fetch(beta_t).item())
    tol = max(sc(rtol) * beta0, sc(atol))

    iters, resnorm = 0, beta0
    converged, stalled = bool(beta0 <= tol), False
    V = vs.basis(m + 1, b) if graphs is None else graphs.V
    first = True
    while not converged and not stalled and iters < maxiter and resnorm > 0:
        with span("gmres.restart"):
            if not first:
                r = pre_residual(x)
                beta_t = vs.norm(r)
            beta = sc(fetch(beta_t).item())
        first = False
        prev_resnorm = resnorm
        V.zero_()
        vs.divide_into(V[0], r, torch.where(beta_t > 0, beta_t, one))
        R = np.zeros((m, m), dtype=sc)
        cs = np.zeros(m, dtype=sc)
        sn = np.zeros(m, dtype=sc)
        g = np.zeros(m + 1, dtype=sc)
        g[0] = beta

        k, done, brk = 0, bool(beta <= tol), False
        while k < m and not done:
            with span("gmres.iter"):
                if graphs is None:
                    h_t, hk1_t = arnoldi_step(matvec, M, V, k, one,
                                              cgs2_kernel, cgs2_compensated)
                    col = fetch(torch.cat([h_t, hk1_t[None]])).numpy()
                else:
                    col = graphs.column(k, matvec, M)
                h, hk1 = col[:k + 1], col[k + 1]

                # rotations 0..k-1 applied to the new column
                c = h.copy()
                for i in range(k):
                    ci = cs[i] * c[i] + sn[i] * c[i + 1]
                    c[i + 1] = -sn[i] * c[i] + cs[i] * c[i + 1]
                    c[i] = ci
                # the new rotation zeroing hk1; a hard breakdown is a zero
                # R[k, k] RELATIVE to the column's rotation-invariant scale
                a_ = c[k]
                denom = np.sqrt(a_ * a_ + hk1 * hk1)
                colnorm = np.sqrt(np.sum(h * h) + hk1 * hk1)
                breakdown = bool(denom <= colnorm * eps4)
                c_new = sc(1.0) if breakdown else a_ / denom
                s_new = sc(0.0) if breakdown else hk1 / denom
                cs[k], sn[k] = c_new, s_new
                R[:k + 1, k] = c
                R[k, k] = denom
                gk = g[k]
                g[k] = c_new * gk
                g[k + 1] = -s_new * gk
                res_est = abs(g[k + 1])
                done = bool(res_est <= tol or hk1 <= tiny or breakdown)
                brk = breakdown
                if not breakdown:
                    k += 1
        if graphs is not None:
            graphs.end_cycle()

        with span("gmres.update"):
            y = _back_substitute(R, g, k)
            if k:
                y_t = torch.as_tensor(y[:k], device=device)
                x = x + vs.combine(V, k, y_t)
        resnorm = abs(g[k])
        stalled = k == 0 or (brk and resnorm >= sc(0.99) * prev_resnorm)
        iters += k
        converged = bool(resnorm <= tol)
    return GMRESResult(x=x, iters=iters, resnorm=float(resnorm),
                       converged=converged)
