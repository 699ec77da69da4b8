from navierstokes_tpu_torch.io.dat import read_petsc_vec, write_petsc_vec

__all__ = ["read_petsc_vec", "write_petsc_vec"]
