from navierstokes_tpu_torch.solvers.cg import CGResult, cg
from navierstokes_tpu_torch.solvers.gmres import GMRESResult, gmres
from navierstokes_tpu_torch.solvers.sstep import ca_gmres

__all__ = ["CGResult", "GMRESResult", "ca_gmres", "cg", "gmres"]
