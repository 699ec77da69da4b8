from navierstokes_tpu_torch.sparse.bcsr import bcsr_pattern_from_coo
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
    "bcsr_pattern_from_coo",
    "DIAPattern",
    "ScalarDIA",
    "block_diag_to_dia",
    "build_dia_pattern",
    "diag_blocks_from_dia",
    "scale_rows_dia",
    "zero_rows_dia",
]
