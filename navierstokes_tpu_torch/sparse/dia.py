"""Scalar diagonal (DIA) storage of the 4x4-blocked FEM operator.

`data[k, i] = A[i, i + offsets[k]]` with data of shape (K, ndof).  After
band (lexicographic) node ordering the operator has few distinct offsets
(K = 81 on the channel family), and the static pattern maps every block
entry to one flat position `k * ndof + row` once per mesh.  The SpMV runs
on the component-plane layout (`ops/plane_dia.py`); this module keeps the
pattern and the two in-place transforms the operator preparation needs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DIAPattern:
    """Static scatter map: BCSR block values -> DIA data."""

    offsets: tuple
    ndof: int
    flat_map: np.ndarray         # (nnzb*16,) int64: k*ndof + scalar_row
    nnz: int

    @property
    def K(self) -> int:
        return len(self.offsets)


def build_dia_pattern(indptr: np.ndarray, indices: np.ndarray) -> DIAPattern:
    """Derive the scalar-diagonal pattern from a BCSR4 block pattern."""
    nb = len(indptr) - 1
    ndof = 4 * nb
    rows = np.repeat(np.arange(nb, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)
    bdelta = cols - rows                                    # (nnzb,)

    e = (np.arange(4)[None, :] - np.arange(4)[:, None])     # (a, b): b - a
    deltas = 4 * bdelta[:, None, None] + e[None, :, :]      # (nnzb, 4, 4)
    offsets = np.unique(deltas)
    k_of = np.searchsorted(offsets, deltas)                 # (nnzb, 4, 4)
    scalar_row = 4 * rows[:, None, None] + np.arange(4)[None, :, None]
    flat_map = (k_of * ndof + scalar_row).reshape(-1)
    return DIAPattern(
        offsets=tuple(int(d) for d in offsets),
        ndof=ndof,
        flat_map=flat_map.astype(np.int64),
        nnz=len(rows) * 16,
    )


def zero_rows_dia(offsets: tuple, data: torch.Tensor,
                  is_bc: torch.Tensor) -> torch.Tensor:
    """`MatZeroRows(..., 1.0)` on DIA data: zero the constrained scalar
    rows and put 1 on their diagonal entry.  Returns a new tensor."""
    data = torch.where(is_bc[None, :], torch.zeros((), dtype=data.dtype,
                                                  device=data.device), data)
    k0 = offsets.index(0)
    data[k0] = torch.where(is_bc, torch.ones((), dtype=data.dtype,
                                             device=data.device), data[k0])
    return data


def diag_blocks_from_dia(offsets: tuple, data: torch.Tensor,
                         nb: int) -> torch.Tensor:
    """The (nb, 4, 4) block diagonal of DIA data: D[r, a, b] lives on scalar
    diagonal e = b - a at row 4r + a."""
    out = torch.zeros((nb, 4, 4), dtype=data.dtype, device=data.device)
    for e in range(-3, 4):
        if e not in offsets:
            continue
        row = data[offsets.index(e)].reshape(nb, 4)   # [r, a] = (4r+a, +e)
        for a in range(4):
            b = a + e
            if 0 <= b < 4:
                out[:, a, b] = row[:, a]
    return out
