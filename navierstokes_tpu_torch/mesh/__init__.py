from navierstokes_tpu_torch.mesh.core import Mesh
from navierstokes_tpu_torch.mesh.box import (
    box_mesh,
    channel_mesh,
    scaling_series_mesh,
)

__all__ = ["Mesh", "box_mesh", "channel_mesh", "scaling_series_mesh"]
