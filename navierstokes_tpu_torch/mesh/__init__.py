from navierstokes_tpu_torch.mesh.core import Mesh
from navierstokes_tpu_torch.mesh.box import (
    box_mesh,
    channel_mesh,
    scaling_series_mesh,
)
from navierstokes_tpu_torch.mesh.gmsh import read_gmsh, write_gmsh

__all__ = ["Mesh", "box_mesh", "channel_mesh", "scaling_series_mesh",
           "read_gmsh", "write_gmsh"]
