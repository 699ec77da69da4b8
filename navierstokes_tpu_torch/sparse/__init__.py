from navierstokes_tpu_torch.sparse.bcsr import (
    BCSR4,
    bcsr_from_coo,
    bcsr_matvec,
    bcsr_pattern_from_coo,
)
from navierstokes_tpu_torch.sparse.bell import (
    BlockELL,
    bell_from_bcsr,
    bell_pattern_from_bcsr,
    bell_values_from_bcsr_values,
)
from navierstokes_tpu_torch.sparse.dia import (
    DIAPattern,
    ScalarDIA,
    block_diag_to_dia,
    build_dia_pattern,
    diag_blocks_from_dia,
    scale_rows_dia,
    zero_rows_dia,
)

__all__ = [
    "BCSR4",
    "bcsr_from_coo",
    "bcsr_matvec",
    "bcsr_pattern_from_coo",
    "BlockELL",
    "bell_from_bcsr",
    "bell_pattern_from_bcsr",
    "bell_values_from_bcsr_values",
    "DIAPattern",
    "ScalarDIA",
    "block_diag_to_dia",
    "build_dia_pattern",
    "diag_blocks_from_dia",
    "scale_rows_dia",
    "zero_rows_dia",
]
