"""Restarted GMRES(m): the KSPGMRES equivalent, as a Python loop.

Semantics of the JAX package's `solvers/gmres.py` on its `cgs2='xla'`
path: left preconditioning, CGS2 (classical Gram–Schmidt, twice) against
the live basis rows 0..k, Givens-rotation least squares, convergence when
the preconditioned residual drops below max(rtol * ||r0||, atol) (PETSc
`KSPConvergedDefault`), restart length m, a total-iteration cap, the
relative breakdown guard and the stall exit.

The Krylov vectors stay on the device.  Each inner iteration fetches the
new Hessenberg column (k+2 numbers) in one host sync; the rotations, the
tolerance tests and the small triangular solve run on the host, in numpy
scalars of the working dtype so that float32 rounds as it does on the
device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


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
) -> GMRESResult:
    n = b.shape[0]
    dtype, device = b.dtype, b.device
    sc = scalar_type(dtype)
    eps4 = sc(4.0) * np.finfo(sc).eps
    tiny = sc(1e-300)            # rounds to 0 in float32, as in JAX
    m = restart
    M = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    one = torch.ones((), dtype=dtype, device=device)

    def pre_residual(x):
        return M(b - matvec(x))

    r = pre_residual(x)
    beta_t = torch.linalg.norm(r)
    beta0 = sc(beta_t.item())
    tol = max(sc(rtol) * beta0, sc(atol))

    iters, resnorm = 0, beta0
    converged, stalled = bool(beta0 <= tol), False
    V = torch.zeros((m + 1, n), dtype=dtype, device=device)
    first = True
    while not converged and not stalled and iters < maxiter and resnorm > 0:
        if not first:
            r = pre_residual(x)
            beta_t = torch.linalg.norm(r)
        first = False
        beta = sc(beta_t.item())
        prev_resnorm = resnorm
        V.zero_()
        V[0] = r / torch.where(beta_t > 0, beta_t, one)
        R = np.zeros((m, m), dtype=sc)
        cs = np.zeros(m, dtype=sc)
        sn = np.zeros(m, dtype=sc)
        g = np.zeros(m + 1, dtype=sc)
        g[0] = beta

        k, done, brk = 0, bool(beta <= tol), False
        while k < m and not done:
            w = M(matvec(V[k]))
            Vk = V[:k + 1]                       # the live rows 0..k
            h1 = Vk @ w
            w = w - Vk.T @ h1
            h2 = Vk @ w
            w = w - Vk.T @ h2
            hk1_t = torch.linalg.norm(w)
            V[k + 1] = w / torch.where(hk1_t > 0, hk1_t, one)
            col = torch.cat([h1 + h2, hk1_t[None]]).cpu().numpy()  # one sync
            h, hk1 = col[:k + 1], col[k + 1]

            # rotations 0..k-1 applied to the new column
            c = h.copy()
            for i in range(k):
                ci = cs[i] * c[i] + sn[i] * c[i + 1]
                c[i + 1] = -sn[i] * c[i] + cs[i] * c[i + 1]
                c[i] = ci
            # the new rotation zeroing hk1; a hard breakdown is a zero R[k, k]
            # RELATIVE to the column's rotation-invariant scale
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

        y = _back_substitute(R, g, k)
        if k:
            y_t = torch.as_tensor(y[:k], device=device)
            x = x + V[:k].T @ y_t
        resnorm = abs(g[k])
        stalled = k == 0 or (brk and resnorm >= sc(0.99) * prev_resnorm)
        iters += k
        converged = bool(resnorm <= tol)
    return GMRESResult(x=x, iters=iters, resnorm=float(resnorm),
                       converged=converged)
