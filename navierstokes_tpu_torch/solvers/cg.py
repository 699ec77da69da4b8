"""Preconditioned conjugate gradients, as a Python loop over device tensors.

For SPD sub-problems (the pressure-Poisson block); the Navier–Stokes
saddle-point system itself is indefinite, so the model's `method='cg'`
routes it here only on request.  Convergence as PETSc's
`KSPConvergedDefault` in the natural M-inner-product norm:
sqrt(r . M^{-1} r) < max(rtol * norm0, atol).  The host reads that norm
once per iteration, in the working dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from navierstokes_tpu_torch.solvers.gmres import scalar_type
from navierstokes_tpu_torch.utils.profiling import fetch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: float
    converged: bool


def _identity(x):
    return x


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       *, precond: Optional[Callable] = None, rtol: float = 1e-10,
       atol: float = 1e-12, maxiter: int = 2000) -> CGResult:
    sc = scalar_type(b.dtype)
    M = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x)
    p = M(r)
    rz = torch.dot(r, p)
    resnorm = np.sqrt(np.abs(sc(fetch(rz).item())))
    tol = max(sc(rtol) * resnorm, sc(atol))
    iters = 0
    while resnorm > tol and iters < maxiter:
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        iters += 1
        resnorm = np.sqrt(np.abs(sc(fetch(rz).item())))
    return CGResult(x=x, iters=iters, resnorm=float(resnorm),
                    converged=bool(resnorm <= tol))
