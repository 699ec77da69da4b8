"""Distribution: the solver row-partitioned over a list of devices (ROADMAP
slice 15), its partitioned operators and assembly, and the port's copies
of the two multi-device checks of `__graft_entry__.py` (`dryrun`)."""

from navierstokes_tpu_torch.parallel.distributed import (
    DistributedNavierStokesSolver,
)
from navierstokes_tpu_torch.parallel.partitioned import (
    ElementPartition,
    build_element_partition,
    partitioned_assemble_dia,
    partitioned_spmv_dia,
    partitioned_spmv_dia_power,
    partitioned_spmv_plane,
)

__all__ = [
    "DistributedNavierStokesSolver",
    "ElementPartition",
    "build_element_partition",
    "partitioned_assemble_dia",
    "partitioned_spmv_dia",
    "partitioned_spmv_dia_power",
    "partitioned_spmv_plane",
]
