from navierstokes_tpu_torch.sparse.bcsr import bcsr_pattern_from_coo
from navierstokes_tpu_torch.sparse.dia import (
    DIAPattern,
    build_dia_pattern,
    diag_blocks_from_dia,
    zero_rows_dia,
)

__all__ = [
    "bcsr_pattern_from_coo",
    "DIAPattern",
    "build_dia_pattern",
    "diag_blocks_from_dia",
    "zero_rows_dia",
]
