from navierstokes_tpu_torch.io.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from navierstokes_tpu_torch.io.dat import read_petsc_vec, write_petsc_vec
from navierstokes_tpu_torch.io.vtu import write_pvd, write_vtu

__all__ = ["load_checkpoint", "read_petsc_vec", "save_checkpoint",
           "write_petsc_vec", "write_pvd", "write_vtu"]
