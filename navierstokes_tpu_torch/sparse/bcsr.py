"""Block CSR with 4x4 blocks (BCSR4): the pattern on the host, the values
a tensor.

The block sparsity pattern of a mesh is static (one 4x4 block per adjacent
node pair), so it lives in numpy; the values are an (nnzb, 4, 4) tensor.
The assembly maps element node pairs to block slots
(`bcsr_pattern_from_coo`), and the scalar-DIA pattern of the solver path is
derived from the block pattern.  `bcsr_matvec` is the plain block matvec of
the host oracles and the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.ops.scatter import index_add_fixed_order


@dataclasses.dataclass
class BCSR4:
    """Block-CSR matrix of (nb x nb) 4x4 blocks.

    indptr:  (nb + 1,) numpy: block-row pointers.
    indices: (nnzb,) numpy: block-column indices, sorted per row.
    values:  (nnzb, 4, 4) tensor.
    """

    indptr: np.ndarray
    indices: np.ndarray
    values: torch.Tensor

    @property
    def nb(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnzb(self) -> int:
        return len(self.indices)

    @property
    def nnz(self) -> int:
        """Scalar nonzero count (for the 2*nnz/t GFLOP/s convention)."""
        return self.nnzb * 16

    @property
    def shape(self) -> tuple:
        return (4 * self.nb, 4 * self.nb)

    def row_ids(self) -> np.ndarray:
        """(nnzb,) block row of each stored block."""
        return np.repeat(np.arange(self.nb, dtype=np.int32),
                         np.diff(self.indptr))

    def to_dense(self) -> np.ndarray:
        """Dense (4 nb, 4 nb) numpy matrix: small problems and tests."""
        nb = self.nb
        vals = self.values.detach().cpu().numpy()
        dense = np.zeros((nb, 4, nb, 4), dtype=vals.dtype)
        np.add.at(dense, (self.row_ids(), slice(None), self.indices), vals)
        return dense.reshape(4 * nb, 4 * nb)

    def diag_slots(self) -> np.ndarray:
        """(nb,) position of each diagonal block in `indices`."""
        slots = np.flatnonzero(self.indices == self.row_ids())
        if len(slots) != self.nb:
            raise ValueError("missing diagonal block")
        return slots.astype(np.int32)


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


def bcsr_from_coo(rows: np.ndarray, cols: np.ndarray, blocks: torch.Tensor,
                  nb: int) -> BCSR4:
    """A BCSR4 from block-COO triplets, duplicates summed in a fixed
    order."""
    indptr, indices, slot = bcsr_pattern_from_coo(rows, cols, nb)
    flat = torch.zeros(len(indices) * 16, dtype=blocks.dtype,
                       device=blocks.device)
    idx = (16 * torch.as_tensor(slot, dtype=torch.int64,
                                device=blocks.device))[:, None] \
        + torch.arange(16, device=blocks.device)
    index_add_fixed_order(flat, idx.reshape(-1), blocks.reshape(-1))
    return BCSR4(indptr=indptr, indices=indices,
                 values=flat.reshape(-1, 4, 4))


def bcsr_matvec(m: BCSR4, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a BCSR4 on an interleaved (4 nb,) vector: each block
    times its column's 4-vector, added into its row in a fixed order."""
    dev = m.values.device
    cols = torch.as_tensor(m.indices, dtype=torch.int64, device=dev)
    rows = torch.as_tensor(m.row_ids(), dtype=torch.int64, device=dev)
    prod = (m.values @ x.reshape(-1, 4)[cols][:, :, None])[:, :, 0]
    y = torch.zeros((m.nb, 4), dtype=prod.dtype, device=dev)
    return index_add_fixed_order(y, rows, prod).reshape(-1)
