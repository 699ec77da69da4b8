"""Frozen float64 copy of the P1 tetrahedral assembly, applied element by
element with no global matrix.

The element matrices are the reference project's closed forms
(`src/integration.c`): P1 velocity and pressure on tets, the viscous term
(2/Re) vol S^T W S, the mass matrix over dt, the divergence B, its
transpose and the Brezzi-Pitkaranta pressure stabilization
delta h^2 vol grad.grad.  The shape-function gradients keep the reference's
sign (they are the negated gradients) and every block is built to match.
Global DoF 4 i + c holds component c (u_x, u_y, u_z, p) of node i.

`ElementOperators.apply(terms, U)` computes A U for a stack of vectors U
(ndof, k) by gathering each element's 16 DoF, multiplying by its 16 x 16
matrix and adding the result back, in chunks of elements.  Nothing here
reads anything the system under test has made: the mesh arrays are the
benchmark's own.
"""

from __future__ import annotations

import numpy as np
import torch

_VOIGT_WEIGHTS = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5)
TERMS = frozenset({"diffusion", "mass_dt", "mass_dt_bare"})
# The operators of the transient run: the Stokes initialization, the
# backward-Euler operator A_lin and the bare velocity mass over dt.
STOKES = frozenset({"diffusion"})
LINEAR = frozenset({"mass_dt", "diffusion"})
MASS = frozenset({"mass_dt_bare"})


def _cross(u, v):
    return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                        u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                        u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)


def geometry(a: torch.Tensor) -> tuple:
    """(vol, grad, h) of elements with vertices a (E, 4, 3)."""
    e = a[:, 1:] - a[:, :1]
    det = (e[:, 0, 0] * (e[:, 1, 1] * e[:, 2, 2] - e[:, 1, 2] * e[:, 2, 1])
           - e[:, 0, 1] * (e[:, 1, 0] * e[:, 2, 2] - e[:, 1, 2] * e[:, 2, 0])
           + e[:, 0, 2] * (e[:, 1, 0] * e[:, 2, 1] - e[:, 1, 1] * e[:, 2, 0]))
    vol = det / 6.0
    vol6 = (e[:, 0] * _cross(e[:, 1], e[:, 2])).sum(-1, keepdim=True)
    faces = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))
    grad = torch.stack([_cross(a[:, k] - a[:, j], a[:, l] - a[:, j]) / vol6
                        for j, k, l in faces], dim=1)
    diff = a[:, :, None, :] - a[:, None, :, :]
    h = torch.sqrt((diff * diff).sum(-1).reshape(a.shape[0], 16).max(1).values)
    return vol, grad, h


def element_matrices(vol, grad, h, *, terms: frozenset, dt: float,
                     reynolds: float, delta: float) -> torch.Tensor:
    """(E, 16, 16) element matrices, row and column 4 i + c."""
    unknown = set(terms) - TERMS
    if unknown:
        raise ValueError(f"unknown terms {sorted(unknown)}")
    E, dtype, dev = vol.shape[0], vol.dtype, vol.device
    vv = torch.zeros((E, 12, 12), dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    if "diffusion" in terms:
        S = torch.zeros((E, 6, 4, 3), dtype=dtype, device=dev)
        for r, (p, q) in enumerate(((0, 0), (1, 1), (2, 2))):
            S[:, r, :, p] = grad[:, :, q]
        for r, (p, q) in zip((3, 4, 5), ((0, 1), (0, 2), (1, 2))):
            S[:, r, :, p] = grad[:, :, q]
            S[:, r, :, q] = grad[:, :, p]
        S = S.reshape(E, 6, 12)
        w = torch.tensor(_VOIGT_WEIGHTS, dtype=dtype, device=dev)
        vv = vv + (2.0 / reynolds) * vol[:, None, None] * (
            (S.transpose(1, 2) * w) @ S)
    if "mass_dt" in terms or "mass_dt_bare" in terms:
        m4 = vol[:, None, None] * (
            torch.full((4, 4), 1.0 / 20.0, dtype=dtype, device=dev)
            + torch.eye(4, dtype=dtype, device=dev) / 20.0)
        vv = vv + torch.einsum("eij,ab->eiajb", m4, eye3).reshape(
            E, 12, 12) / dt
    out = torch.zeros((E, 4, 4, 4, 4), dtype=dtype, device=dev)  # e,i,a,j,b
    out[:, :, :3, :, :3] = vv.reshape(E, 4, 3, 4, 3)
    if "diffusion" in terms or "mass_dt" in terms:
        bt = (vol / 4.0)[:, None, None] * grad            # (e, i, a)
        out[:, :, :3, :, 3] = bt[:, :, :, None]            # B^T: row (i, a)
        out[:, :, 3, :, :3] = -bt[:, None, :, :]           # -B: col (j, b)
        out[:, :, 3, :, 3] = (delta * h * h * vol)[:, None, None] * (
            grad @ grad.transpose(1, 2))
    return out.reshape(E, 16, 16)


class ElementOperators:
    """The operators of one mesh and one set of physical constants, applied
    element by element in float64 on `device`."""

    def __init__(self, coords: np.ndarray, tets: np.ndarray, *, dt: float,
                 reynolds: float, stokes_reynolds: float, delta: float,
                 device, chunk_entries: int = 1 << 25):
        self.device = torch.device(device)
        self.dt, self.reynolds = dt, reynolds
        self.stokes_reynolds, self.delta = stokes_reynolds, delta
        self.ndof = 4 * coords.shape[0]
        c = torch.as_tensor(coords, dtype=torch.float64, device=self.device)
        t = torch.as_tensor(tets, dtype=torch.int64, device=self.device)
        self.vol, self.grad, self.h = geometry(c[t])
        self.dofs = (4 * t[:, :, None] + torch.arange(
            4, device=self.device)).reshape(-1, 16)
        self.chunk_entries = chunk_entries

    def apply(self, terms: frozenset, U: torch.Tensor,
              reynolds: float | None = None) -> torch.Tensor:
        """A U for U (ndof, k), A the unconstrained operator of `terms`."""
        U = U.to(self.device, torch.float64)
        k = U.shape[1]
        out = torch.zeros_like(U)
        ne = self.vol.shape[0]
        step = max(1, self.chunk_entries // (256 + 32 * k))
        re = self.reynolds if reynolds is None else reynolds
        for s in range(0, ne, step):
            e = slice(s, min(s + step, ne))
            Ae = element_matrices(self.vol[e], self.grad[e], self.h[e],
                                  terms=terms, dt=self.dt, reynolds=re,
                                  delta=self.delta)
            d = self.dofs[e]
            out.index_add_(0, d.reshape(-1), (Ae @ U[d]).reshape(-1, k))
        return out
