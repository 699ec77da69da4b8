"""Block-CSR (4x4 blocks) pattern build on the host.

Only the pattern half of the JAX package's `sparse/bcsr.py` is on the
ported path: the assembly maps element node pairs to block slots, and the
scalar-DIA pattern is derived from the block pattern.
"""

from __future__ import annotations

import numpy as np


def bcsr_pattern_from_coo(rows: np.ndarray, cols: np.ndarray, nb: int):
    """Deduplicated, sorted BCSR pattern from block COO coordinates.

    Returns (indptr, indices, slot_of_coo) where slot_of_coo maps each input
    (row, col) pair to its block slot — the scatter map used by assembly.
    """
    keys = rows.astype(np.int64) * nb + cols.astype(np.int64)
    uniq, slot_of_coo = np.unique(keys, return_inverse=True)
    u_rows = (uniq // nb).astype(np.int32)
    u_cols = (uniq % nb).astype(np.int32)
    indptr = np.zeros(nb + 1, dtype=np.int32)
    np.add.at(indptr, u_rows + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int32)
    return indptr, u_cols, slot_of_coo.astype(np.int32)
