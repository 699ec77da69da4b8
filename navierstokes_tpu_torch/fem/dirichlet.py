"""Dirichlet boundary conditions from surface tags
(`src/solve_newton.c:987-1035`), as dense per-DoF masks:

  tag 1 (obstacle): u = 0                       (all three velocity DoF)
  tag 2 (inlet):    u_x = (1-y^2)(1-z^2), u_y = u_z = 0
  tag 4/5:          u_y = 0 only
  tag 6/7:          u_z = 0 only
  tag 3 / interior: free

Pressure DoF are never constrained.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.mesh.core import Mesh


@dataclasses.dataclass
class DirichletBC:
    """is_bc (ndof,) bool, value (ndof,) float, row_bc (nb, 4) bool."""

    is_bc: torch.Tensor
    value: torch.Tensor
    row_bc: torch.Tensor

    @property
    def count(self) -> int:
        return int(self.is_bc.sum())


def build_dirichlet(mesh: Mesh, dtype: torch.dtype,
                    device: torch.device) -> DirichletBC:
    nv = mesh.nv
    tags = mesh.node_tags
    y = mesh.coords[:, 1]
    z = mesh.coords[:, 2]

    is_bc = np.zeros((nv, 4), dtype=bool)
    value = np.zeros((nv, 4), dtype=np.float64)

    noslip = (tags == 1) | (tags == 2)
    is_bc[noslip, 0:3] = True
    inlet = tags == 2
    value[inlet, 0] = (1.0 - y[inlet] ** 2) * (1.0 - z[inlet] ** 2)

    slip_y = (tags == 4) | (tags == 5)
    is_bc[slip_y, 1] = True
    slip_z = (tags == 6) | (tags == 7)
    is_bc[slip_z, 2] = True

    return DirichletBC(
        is_bc=torch.as_tensor(is_bc.reshape(-1), device=device),
        value=torch.as_tensor(value.reshape(-1), dtype=dtype, device=device),
        row_bc=torch.as_tensor(is_bc, device=device),
    )
