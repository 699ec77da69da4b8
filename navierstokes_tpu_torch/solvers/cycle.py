"""The preconditioner's cycle algebra, written once for every prep kind.

Each function builds a closure over the applies its caller supplies: the
single-device 'tlp', 'tl', 'sch' and 'bj' operators
(`model/navier_stokes.py`) and the distributed ones on `Shards`
(`parallel/distributed.py`) are compositions of these pieces, and their
spans (`pc.apply`, `pc.smooth`, the cycle names of 'sch') are opened here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from navierstokes_tpu_torch.solvers.coarse import (
    CoarseSpace,
    prolong_planes,
    restrict_planes,
)
from navierstokes_tpu_torch.utils.profiling import wrap


def block_dinv(d: torch.Tensor, n: int) -> Callable:
    """r -> D^{-1} r for a block-diagonal D^{-1} of n x n node blocks held
    as (n * n, L) planes (row n*a + b holds D^{-1}[:, a, b]), on a
    plane-major (n * L,) vector: n * n elementwise plane multiplies."""
    d3 = d.reshape(n, n, -1)

    def apply(r):
        return (d3 * r.reshape(1, n, -1)).sum(1).reshape(-1)
    return apply


def cheby_interval(lmax: float, fraction: float, degree: int) -> tuple:
    """(theta, delta, degree) of the interval [fraction * lmax, 1.05 *
    lmax], centre and half-width."""
    a, b = fraction * lmax, 1.05 * lmax
    return (float((a + b) / 2), float((b - a) / 2), int(degree))


def smoother(apply_A: Callable, apply_Dinv: Callable,
             cheby: Optional[tuple]) -> Callable:
    """Post-smoother of the two-grid cycle: one Jacobi application, or
    the degree-`deg` Chebyshev polynomial in G = D^{-1}A over
    [theta - delta, theta + delta] (Adams/Brezina/Hu/Tuminaro 2003)."""
    if not cheby:
        return wrap("pc.smooth")(apply_Dinv)
    theta, delta, deg = cheby
    sigma1 = theta / delta

    @wrap("pc.smooth")
    def smooth(s):
        dk = apply_Dinv(s) * (1.0 / theta)
        x = dk
        rho_prev = 1.0 / sigma1
        for _ in range(deg - 1):
            rk = s - apply_A(x)
            rho = 1.0 / (2.0 * sigma1 - rho_prev)
            dk = (rho * rho_prev) * dk + (2.0 * rho / delta) * \
                apply_Dinv(rk)
            x = x + dk
            rho_prev = rho
        return x

    return smooth


def dense_solve(ac_inv: torch.Tensor) -> Callable:
    """rc -> A_c^{-1} rc: one dense GEMV."""
    return lambda rc: ac_inv @ rc


def plane_coarse(cs: CoarseSpace, solve: Callable, nbp: int, nb: int,
                 n: int) -> Callable:
    """r -> P solve(R r) on an n-component plane-major vector, the padding
    rows nb..nbp at exact zero."""
    def correct(r):
        zc = solve(restrict_planes(cs, r, nbp, n))
        return prolong_planes(cs, zc, nbp, nb, n)
    return correct


def two_grid(coarse: Callable, smooth: Callable, apply_A: Callable,
             name: str) -> Callable:
    """The multiplicative two-grid cycle in span `name`: the coarse
    correction, then the smoother on its residual."""
    @wrap(name)
    def cycle(r):
        z = coarse(r)
        return z + smooth(r - apply_A(z))
    return cycle


def two_level_operators(apply_A: Callable, apply_Dinv: Callable,
                        coarse: Callable, cheby: Optional[tuple]) -> tuple:
    """(matvec, minv, parts) of GMRES on M^{-1} A, M^{-1} the two-grid
    cycle in span `pc.apply` with the smoother of `cheby`."""
    minv = two_grid(coarse, smoother(apply_A, apply_Dinv, cheby), apply_A,
                    "pc.apply")

    def matvec(x):
        return minv(apply_A(x))

    return matvec, minv, {"apply_A": apply_A, "apply_Dinv": apply_Dinv,
                          "coarse": coarse, "minv": minv}


def neumann_operators(apply_S: Callable, apply_Dinv: Callable,
                      order: int) -> tuple:
    """(matvec, b_prep, parts) of GMRES on the Neumann-boosted S = D^{-1}
    A: the series r -> sum_{k <= order} (I - S)^k r in span `pc.apply`,
    each term one more apply of S, after S or after D^{-1} on the raw
    right-hand side."""
    @wrap("pc.apply")
    def series(r):
        acc = r
        cur = r
        for _ in range(order):
            cur = cur - apply_S(cur)
            acc = acc + cur
        return acc

    def matvec(x):
        return series(apply_S(x))

    def b_prep(rhs):
        return series(apply_Dinv(rhs))

    return matvec, b_prep, {"apply_S": apply_S, "neumann": series}
