from navierstokes_tpu_torch.ops.block import block4_inverse
from navierstokes_tpu_torch.ops.dia import spmv_dia
from navierstokes_tpu_torch.ops.plane_dia import spmv_plane, spmv_planes

__all__ = ["block4_inverse", "spmv_dia", "spmv_plane", "spmv_planes"]
