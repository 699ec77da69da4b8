"""Arnoldi on device tensors.

Only `arnoldi` is ported: the model uses it to estimate the largest
eigenvalue of D^{-1}A for the Chebyshev smoother.  The recycling
(`harmonic_ritz_basis`, `recycle_space`) waits for ROADMAP slice 13.
"""

from __future__ import annotations

from typing import Callable

import torch


def arnoldi(matvec: Callable, v0: torch.Tensor, m: int):
    """m-step Arnoldi with CGS2 orthogonalization.  Returns (V, Hbar): V
    (m+1, n) row-major orthonormal basis, Hbar (m+1, m) upper Hessenberg
    with matvec(V[:m].T) = V.T @ Hbar.  The projections run over the whole
    (m+1)-row buffer with the live rows 0..k masked, as the JAX package
    does."""
    n = v0.shape[0]
    dtype, device = v0.dtype, v0.device
    one = torch.ones((), dtype=dtype, device=device)
    beta = torch.linalg.norm(v0)
    V = torch.zeros((m + 1, n), dtype=dtype, device=device)
    V[0] = v0 / torch.where(beta > 0, beta, one)
    H = torch.zeros((m + 1, m), dtype=dtype, device=device)
    rows = torch.arange(m + 1, device=device)
    for k in range(m):
        w = matvec(V[k])
        active = (rows <= k).to(dtype)
        h1 = (V @ w) * active
        w = w - V.T @ h1
        h2 = (V @ w) * active
        w = w - V.T @ h2
        h = h1 + h2
        hk1 = torch.linalg.norm(w)
        V[k + 1] = w / torch.where(hk1 > 0, hk1, one)
        h[k + 1] = hk1
        H[:, k] = h
    return V, H
