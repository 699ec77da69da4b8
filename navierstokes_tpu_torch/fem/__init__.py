from navierstokes_tpu_torch.fem import elements
from navierstokes_tpu_torch.fem.assembly import (
    FULL_JACOBIAN_TERMS,
    LINEAR_TERMS,
    NONLINEAR_TERMS,
    STOKES_TERMS,
    Discretization,
    assemble_bcsr_values,
    assemble_dia_values,
    assemble_operator,
    assemble_residual,
    build_discretization,
    local_fields,
)
from navierstokes_tpu_torch.fem.dirichlet import (
    DirichletBC,
    build_dirichlet,
    zero_rows_bcsr,
)

__all__ = [
    "elements",
    "FULL_JACOBIAN_TERMS",
    "LINEAR_TERMS",
    "NONLINEAR_TERMS",
    "STOKES_TERMS",
    "Discretization",
    "assemble_bcsr_values",
    "assemble_dia_values",
    "assemble_operator",
    "assemble_residual",
    "build_discretization",
    "local_fields",
    "DirichletBC",
    "build_dirichlet",
    "zero_rows_bcsr",
]
