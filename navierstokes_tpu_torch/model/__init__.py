from navierstokes_tpu_torch.model.navier_stokes import (
    NavierStokesSolver,
    NewtonStats,
)

__all__ = ["NavierStokesSolver", "NewtonStats"]
