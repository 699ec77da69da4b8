"""s-step (communication-avoiding) GMRES, as a Python loop over device
tensors: the JAX package's `solvers/sstep.py`.

Per restart cycle (Walker/Hoemmen-style):
  1. r0 = M^{-1}(b - A x); the basis V = [v0, v1, ..., vm] of the
     normalized powers of T = M^{-1}A, with the recurrence coefficients in
     S: T v_i = theta_i v_i + alpha_i v_{i+1} (theta_i = 0, the monomial
     basis; or the Leja-ordered Ritz values of `newton_shifts`, the Newton
     basis, which does not stall in float32 as the monomial one does).
     The basis is a loop of `matvec` calls, as in the JAX package: on the
     plane and scalar layouts each is one K1 or K2 launch per operator
     apply on the card.
  2. Tall-skinny QR: V = Q R (`torch.linalg.qr`).
  3. The Arnoldi projection without inner products against A:
     H = R S R_m^{-1} (H (m+1, m)).
  4. The small least squares min ||v0norm R[:, 0] - H y||.
  5. x += Q_m y; restart until the true preconditioned residual converges
     or stops decreasing.
Iterations are counted as in the JAX package: m per cycle.  The shifts
and the Leja order are computed on the host in float64.  The vectors are
one tensor or the distributed solver's shards (`solvers/vectors.py`; the
tall-skinny QR is then a QR per shard and one of the stacked R factors),
and `powers_fn` takes the whole raw power stack from one call: on the
distributed 'bj' path the one-exchange sweep
`parallel.partitioned_spmv_dia_power`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from navierstokes_tpu_torch.solvers import vectors as vs
from navierstokes_tpu_torch.solvers.gmres import GMRESResult, scalar_type
from navierstokes_tpu_torch.utils.profiling import fetch


def _identity(x):
    return x


def leja_order(vals) -> np.ndarray:
    """Greedy Leja ordering of a point set (host, numpy).

    out[0] = argmax |v|; out[k] maximizes sum_j log|v - out[j]| over the
    remaining points (log sums: the raw products over- or underflow beyond
    ~30 points).  A duplicate point scores -inf once its twin is chosen and
    lands last (equal shifts repeat)."""
    v = np.asarray(vals)
    n = v.shape[0]
    if n == 0:
        return v
    chosen = [int(np.argmax(np.abs(v)))]
    rest = [i for i in range(n) if i != chosen[0]]
    with np.errstate(divide="ignore"):
        score = np.log(np.abs(v - v[chosen[0]]))
    while rest:
        j = max(rest, key=lambda i: score[i])
        chosen.append(j)
        rest.remove(j)
        with np.errstate(divide="ignore"):
            score = score + np.log(np.abs(v - v[j]))
    return v[chosen]


def newton_shifts(H, s: int) -> tuple:
    """`s` Leja-ordered real Newton-basis shifts from an Arnoldi Hessenberg
    H ((m+1, m) or (m, m)): the Ritz values of its square part in float64,
    reduced to their real parts (a real recurrence), Leja-ordered, cycled
    where s > m."""
    h = np.asarray(H, dtype=np.float64)
    m = min(h.shape)
    theta = np.linalg.eigvals(h[:m, :m])
    ordered = leja_order(np.real(theta))
    reps = -(-s // ordered.shape[0])
    return tuple(float(t) for t in np.tile(ordered, reps)[:s])


def ca_gmres(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, *,
             precond: Optional[Callable] = None, basis: int = 12,
             rtol: float = 1e-10, atol: float = 1e-12, maxiter: int = 2000,
             shifts: Optional[tuple] = None,
             powers_fn: Optional[Callable] = None) -> GMRESResult:
    """Restarted s-step GMRES with basis length `basis` (= s = m per
    cycle); `shifts` (at least m floats, from `newton_shifts`) switches the
    basis from monomial to Newton.  `powers_fn(v, m)` gives the raw
    monomial stack [A v, ..., A^m v] (n, m) in one call (the preconditioner
    folded into A; the JAX package's `powers_fn`); the normalized columns
    and the recurrence coefficients come from its column norms.  Without
    it `matvec` is applied m times."""
    if powers_fn is not None and (precond is not None or shifts is not None):
        raise ValueError("powers_fn takes the monomial basis with the "
                         "preconditioner folded into A")
    dtype, device = b.dtype, b.device
    sc = scalar_type(dtype)
    m = basis
    if shifts is not None:
        if len(shifts) < m:
            raise ValueError(f"need >= basis={m} shifts, got {len(shifts)}")
        shifts = tuple(shifts[:m])
    M = precond or _identity
    x = vs.zeros_like(b) if x0 is None else x0.clone()
    # 1e-300 in the working dtype: 0 in float32, as in the JAX package
    eps_floor = torch.tensor(1e-300, dtype=dtype, device=device)
    th = [0.0] * m if shifts is None else list(shifts)

    def pre_residual(x):
        return M(b - matvec(x))

    def basis_powers(v):
        """[v | the normalized raw powers], and the alphas from the raw
        column norms (v_{i+1} = raw_{i+1} / |raw_{i+1}|)."""
        raw = powers_fn(v, m)
        norms = vs.column_norms(raw)
        V = vs.prepend_column(v, raw / torch.maximum(norms, eps_floor)[None])
        prev = torch.cat([torch.ones((1,), dtype=dtype, device=device),
                          norms[:-1]])
        return V, norms / torch.maximum(prev, eps_floor)

    def basis_chain(v):
        cols, alphas = [v], []
        for i in range(m):
            w = M(matvec(v)) - th[i] * v
            alpha = vs.norm(w)
            v = w / torch.maximum(alpha, eps_floor)
            cols.append(v)
            alphas.append(alpha)
        return vs.columns(cols), torch.stack(alphas)

    def cycle(x):
        r = pre_residual(x)
        v0norm = vs.norm(r)
        v = r / torch.maximum(v0norm, eps_floor)
        V, alphas = (basis_chain if powers_fn is None else basis_powers)(v)
        Q, R = vs.qr(V)                                     # (n, m+1)
        S = torch.zeros((m + 1, m), dtype=dtype, device=device)
        idx = torch.arange(m, device=device)
        S[idx + 1, idx] = alphas
        if shifts is not None:
            S[idx, idx] = torch.tensor(shifts, dtype=dtype, device=device)
        H = torch.linalg.solve_triangular(R[:m, :m].T, (R @ S).T,
                                          upper=False).T      # (m+1, m)
        g = v0norm * R[:, 0]
        Qh, Rh = torch.linalg.qr(H, mode="complete")
        gh = Qh.T @ g
        y = torch.linalg.solve_triangular(Rh[:m], gh[:m, None],
                                          upper=True)[:, 0]
        return x + vs.apply_columns(Q, m, y)

    beta0 = sc(fetch(vs.norm(pre_residual(x))).item())
    tol = max(sc(rtol) * beta0, sc(atol))
    shrink = sc(1 - 1e-12)          # 1 in float32, as in the JAX package
    iters, prev_res = 0, beta0
    converged, stalled = bool(beta0 <= tol), False
    while not converged and not stalled and iters < maxiter:
        x = cycle(x)
        # the true preconditioned residual decides convergence
        true_res = sc(fetch(vs.norm(pre_residual(x))).item())
        stalled = not (true_res < prev_res * shrink) and true_res > tol
        iters += m
        prev_res = true_res
        converged = bool(true_res <= tol)
    return GMRESResult(x=x, iters=iters, resnorm=float(prev_res),
                       converged=converged)
