"""Padded block-ELL: every block row stores exactly `slots` 4x4 blocks.

The JAX package's `sparse/bell.py`.  A row of fewer blocks than `slots`
(the maximum row degree unless asked for more) is padded with zero blocks
that point at the row's own block column, so a gather stays local:

  indices: (nb, slots)        int32 numpy, the block column of each slot
  values:  (nb, slots, 4, 4)  tensor, zero in the padding slots

The pattern is the block-CSR pattern's (columns sorted per row), slot for
slot, so `ell_indices` equals the JAX package's exactly.  The block-ELL
SpMV is `ops/spmv.spmv_bell`: a gather and a batched 4x4 product in plain
PyTorch (the JAX package's is XLA's gather and einsum; no Pallas kernel
reaches it).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.sparse.bcsr import BCSR4


@dataclasses.dataclass
class BlockELL:
    indices: np.ndarray      # (nb, slots) int32, host (static pattern)
    values: torch.Tensor     # (nb, slots, 4, 4)
    nnzb: int                # true (unpadded) block count

    @property
    def nb(self) -> int:
        return self.indices.shape[0]

    @property
    def slots(self) -> int:
        return self.indices.shape[1]

    @property
    def nnz(self) -> int:
        return self.nnzb * 16

    @property
    def shape(self) -> tuple:
        return (4 * self.nb, 4 * self.nb)

    def to_dense(self) -> np.ndarray:
        """Dense (4 nb, 4 nb) numpy matrix: small problems and tests."""
        nb, k = self.indices.shape
        vals = self.values.detach().cpu().numpy()
        dense = np.zeros((nb, 4, nb, 4), dtype=vals.dtype)
        rows = np.repeat(np.arange(nb), k)
        np.add.at(dense, (rows, slice(None), self.indices.reshape(-1)),
                  vals.reshape(-1, 4, 4))
        return dense.reshape(4 * nb, 4 * nb)


def bell_pattern_from_bcsr(indptr: np.ndarray, indices: np.ndarray,
                           slots=None) -> tuple:
    """(ell_indices (nb, S) int32, slot_of_bcsr (nnzb,) int64): the
    pattern and the map of each BCSR block to its flat ELL slot r * S + j.

    Block j of row r goes to slot j; padding slots point at the row's own
    index.  `slots` below the maximum row degree raises a ValueError."""
    nb = len(indptr) - 1
    degrees = np.diff(indptr)
    k = int(degrees.max()) if len(degrees) else 0
    if slots is not None:
        if slots < k:
            raise ValueError(f"slots={slots} < max row degree {k}")
        k = slots
    rows = np.repeat(np.arange(nb, dtype=np.int64), degrees)
    pos = np.arange(len(indices), dtype=np.int64) - indptr[rows]
    ell_indices = np.repeat(np.arange(nb, dtype=np.int32)[:, None], k, axis=1)
    ell_indices[rows, pos] = indices
    return ell_indices, rows * k + pos


def bell_values_from_bcsr_values(bcsr_values: torch.Tensor,
                                 slot_of_bcsr: np.ndarray, nb: int,
                                 slots: int) -> torch.Tensor:
    """(nb, slots, 4, 4) values from BCSR values (nnzb, 4, 4) on a fixed
    pattern: one indexed copy (each slot is written once, so the result
    does not depend on an order)."""
    dev = bcsr_values.device
    vals = torch.zeros((nb * slots, 4, 4), dtype=bcsr_values.dtype,
                       device=dev)
    vals.index_copy_(0, torch.as_tensor(slot_of_bcsr, dtype=torch.int64,
                                        device=dev), bcsr_values)
    return vals.reshape(nb, slots, 4, 4)


def bell_from_bcsr(m: BCSR4, slots=None) -> BlockELL:
    """The block-ELL form of a BCSR4, values on the BCSR values' device."""
    ell_indices, slot_of_bcsr = bell_pattern_from_bcsr(m.indptr, m.indices,
                                                       slots)
    nb, k = ell_indices.shape
    return BlockELL(indices=ell_indices,
                    values=bell_values_from_bcsr_values(m.values,
                                                        slot_of_bcsr, nb, k),
                    nnzb=m.nnzb)
