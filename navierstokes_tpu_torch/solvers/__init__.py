from navierstokes_tpu_torch.solvers.gmres import GMRESResult, gmres

__all__ = ["GMRESResult", "gmres"]
