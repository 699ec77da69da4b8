"""The plain reference's reading of a transient run: Dirichlet data, the
Stokes residual and the backward-Euler residual, in float64.

The run it judges (`src/solve_newton.c`): a Stokes solve A_s x = b, where
the rows of constrained DoF are the identity and b holds the boundary
values there and zeros elsewhere; then backward-Euler steps whose answer
u_new, with the boundary values inserted, solves
F(u_new) = A_lin u_new - (M/dt) u_old = 0 on the free rows, to Newton's
tolerance |F| < max(rtol |F(u_old)|, atol).  Each number below is a
property of an answer alone: the reference never needs the system's
operators, preconditioners or iterates.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.fem import LINEAR, MASS, STOKES, ElementOperators


def dirichlet(coords: np.ndarray, tags: np.ndarray) -> tuple:
    """(is_bc, value) per DoF (4 nv,): tag 1 no-slip, tag 2 the inlet's
    Poiseuille u_x = (1 - y^2)(1 - z^2) with u_y = u_z = 0, tags 4/5 u_y = 0,
    tags 6/7 u_z = 0; pressure never constrained."""
    nv = coords.shape[0]
    is_bc = np.zeros((nv, 4), dtype=bool)
    value = np.zeros((nv, 4), dtype=np.float64)
    noslip = (tags == 1) | (tags == 2)
    is_bc[noslip, :3] = True
    inlet = tags == 2
    y, z = coords[inlet, 1], coords[inlet, 2]
    value[inlet, 0] = (1.0 - y ** 2) * (1.0 - z ** 2)
    is_bc[(tags == 4) | (tags == 5), 1] = True
    is_bc[(tags == 6) | (tags == 7), 2] = True
    return is_bc.reshape(-1), value.reshape(-1)


class Reference:
    """One mesh and one configuration's physical constants."""

    def __init__(self, coords, tets, tags, cfg: dict, device):
        self.ops = ElementOperators(
            coords, tets, dt=cfg["dt"], reynolds=cfg["reynolds"],
            stokes_reynolds=cfg["stokes_reynolds"], delta=cfg["delta"],
            device=device)
        is_bc, value = dirichlet(coords, tags)
        dev = self.ops.device
        self.is_bc = torch.as_tensor(is_bc, device=dev)
        self.free = ~self.is_bc
        self.value = torch.as_tensor(value, device=dev)
        self.rtol = cfg["newton"]["rtol"]
        self.atol = cfg["newton"]["atol"]

    def _cols(self, states) -> torch.Tensor:
        return torch.stack([torch.as_tensor(s).to(self.ops.device,
                                                  torch.float64).reshape(-1)
                            for s in states], dim=1)

    def stokes_residual(self, x) -> float:
        """|b - A_s x| / |b| of the Stokes system as the run poses it."""
        X = self._cols([x])
        r = torch.where(self.is_bc, self.value - X[:, 0],
                        -self.ops.apply(STOKES, X,
                                        self.ops.stokes_reynolds)[:, 0])
        return float(torch.linalg.norm(r) / torch.linalg.norm(self.value))

    def step_residuals(self, pairs) -> list:
        """For each (u_old, u_new): |F(u_new)| / max(rtol |F(u_old)|, atol)
        on the free rows, the ratio that Newton's own test holds below 1."""
        old, new = self._cols([p[0] for p in pairs]), \
            self._cols([p[1] for p in pairs])
        k = old.shape[1]
        a = self.ops.apply(LINEAR, torch.cat([new, old], dim=1))
        m = self.ops.apply(MASS, old)
        f_new = (a[:, :k] - m)[self.free]
        f_old = (a[:, k:] - m)[self.free]
        num = torch.linalg.norm(f_new, dim=0)
        den = torch.clamp(self.rtol * torch.linalg.norm(f_old, dim=0),
                          min=self.atol)
        return (num / den).tolist()

    def bc_errors(self, states) -> list:
        """max |u - g| over the constrained DoF of each state."""
        X = self._cols(states)
        return (X[self.is_bc] - self.value[self.is_bc, None]).abs().amax(
            0).tolist()
