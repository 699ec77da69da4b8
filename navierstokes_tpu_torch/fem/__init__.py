from navierstokes_tpu_torch.fem import elements
from navierstokes_tpu_torch.fem.assembly import (
    LINEAR_TERMS,
    STOKES_TERMS,
    Discretization,
    assemble_dia_values,
    build_discretization,
)
from navierstokes_tpu_torch.fem.dirichlet import DirichletBC, build_dirichlet

__all__ = [
    "elements",
    "LINEAR_TERMS",
    "STOKES_TERMS",
    "Discretization",
    "assemble_dia_values",
    "build_discretization",
    "DirichletBC",
    "build_dirichlet",
]
