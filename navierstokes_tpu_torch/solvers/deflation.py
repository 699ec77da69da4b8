"""Krylov subspace recycling: GCRO-style spectral deflation, and the
Arnoldi sweep it starts from.

The exact-Jacobian operator is constant across Newton iterations and time
steps, so a subspace that stalls restarted GMRES can be computed once at
operator preparation and projected out of every solve (GCRO / GCRO-DR,
Parks et al. 2006, recycle-once):

  setup (once per prepared operator):
    1. m-step CGS2 Arnoldi on the preconditioned operator T = M^{-1}A:
       T V_m = V_{m+1} Hbar (`arnoldi`, on the device);
    2. harmonic Ritz pairs of Hbar on the host in float64; keep the k
       smallest |theta| (`harmonic_ritz_basis`);
    3. W = V_m Y, C = T W = V_{m+1} (Hbar Y) (no extra matvec), C = Q R,
       U = W R^{-1}: T U = Q with Q^T Q = I (`recycle_space`).
  solve (the model's `_solve_deflated`): GMRES on (I - Q Q^T) T with the
  right-hand side (I - Q Q^T) b, then x = y + U (Q^T (b - T y)).

`arnoldi` also gives the model the largest eigenvalue of D^{-1}A for the
Chebyshev smoother, and the Ritz values of the Newton-basis shifts.  The
small dense algebra (QR, triangular solve) is `torch.linalg`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
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


def harmonic_ritz_basis(Hbar: np.ndarray, k: int) -> np.ndarray:
    """Host (float64) harmonic Ritz extraction from an (m+1, m) Arnoldi
    Hessenberg.

    The harmonic Ritz pairs (theta, y) solve (H_m + h_{m+1,m}^2 H_m^{-T}
    e_m e_m^T) y = theta y; the smallest |theta| approximate the
    eigenvalues nearest zero, the modes that stall restarted GMRES.  A
    complex pair gives its real and imaginary parts (one conjugate per
    pair).  Returns a real orthonormal Y (m, k') with k' <= k."""
    Hbar = np.asarray(Hbar, dtype=np.float64)
    m = Hbar.shape[1]
    H = Hbar[:m]
    h2 = float(Hbar[m, m - 1]) ** 2
    em = np.zeros(m)
    em[-1] = 1.0
    try:
        f = np.linalg.solve(H.T, em)
    except np.linalg.LinAlgError:
        f = np.linalg.lstsq(H.T, em, rcond=None)[0]
    theta, Yc = np.linalg.eig(H + h2 * np.outer(f, em))

    cols, used = [], set()
    for idx in np.argsort(np.abs(theta)):
        if len(cols) >= k:
            break
        if idx in used:
            continue
        used.add(int(idx))
        th, y = theta[idx], Yc[:, idx]
        if abs(th.imag) > 1e-12 * max(abs(th), 1e-300):
            cols.append(y.real)
            cols.append(y.imag)
            # retire the conjugate partner (same invariant plane)
            d = np.abs(theta - np.conj(th))
            d[list(used)] = np.inf
            used.add(int(np.argmin(d)))
        else:
            cols.append(y.real)
    Y, _ = np.linalg.qr(np.stack(cols[:k], axis=1))
    return Y


def recycle_space(V: torch.Tensor, Hbar: torch.Tensor,
                  Y: torch.Tensor) -> tuple:
    """The recycled pair (U, Q), both (k, n) row-major, from the Arnoldi
    basis V (m+1, n), Hbar (m+1, m) and Y (m, k): T U^T = Q^T with
    Q Q^T = I."""
    m = Hbar.shape[1]
    W = Y.T @ V[:m]                        # (k, n) = (V_m Y)^T
    C = (Hbar @ Y).T @ V                   # (k, n) = (T W)^T
    Qt, R = torch.linalg.qr(C.T)           # C^T = Qt R
    # U_mat = W_mat R^{-1}  <=>  rows: U = R^{-T} W
    U = torch.linalg.solve_triangular(R.T, W, upper=False)
    return U, Qt.T
