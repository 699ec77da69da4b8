"""Scalar diagonal (DIA) storage of the 4x4-blocked FEM operator.

`data[k, i] = A[i, i + offsets[k]]` with data of shape (K, ndof).  After
band (lexicographic) node ordering the operator has few distinct offsets
(K = 81 on the channel family), and the static pattern maps every block
entry to one flat position `k * ndof + row` once per mesh.  The scalar-DIA
SpMV is kernel K2 (`ops/dia.py`); the plane path converts the same data to
the component-plane layout (`ops/plane_dia.py`).  This module keeps the
pattern and the transforms the operator preparation needs, including the
block-row scaling S = D^{-1} A of the block-Jacobi path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ScalarDIA:
    """offsets: (K,) sorted scalar diagonals; data: (K, ndof) tensor with
    data[k, i] = A[i, i + offsets[k]].  Entries whose column leaves the
    matrix carry no meaning (the SpMV masks them)."""

    offsets: tuple
    data: torch.Tensor
    nnz: int                     # true scalar nonzeros

    @property
    def ndof(self) -> int:
        return self.data.shape[1]


@dataclasses.dataclass
class DIAPattern:
    """Static scatter map: BCSR block values -> DIA data."""

    offsets: tuple
    ndof: int
    flat_map: np.ndarray         # (nnzb*16,) int64: k*ndof + scalar_row
    nnz: int
    # Static plan for the block-row scaling S = D^{-1} A (scale_rows_dia):
    # scaled_terms[k'] lists the (e, k) with offsets[k] + e ==
    # scaled_offsets[k'].
    scaled_offsets: tuple = ()
    scaled_terms: tuple = ()

    @property
    def K(self) -> int:
        return len(self.offsets)


def scaled_plan(off_list: list) -> tuple:
    """(scaled_offsets, scaled_terms) of S = D^{-1} A: result diagonal
    t = d + e for e in [-3, 3] and d in the operator's offsets."""
    off_set = set(off_list)
    kept, terms = [], []
    for t in sorted({d + e for d in off_list for e in range(-3, 4)}):
        tt = tuple((e, off_list.index(t - e)) for e in range(-3, 4)
                   if (t - e) in off_set)
        if tt:
            kept.append(t)
            terms.append(tt)
    return tuple(kept), tuple(terms)


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
    off_list = [int(d) for d in offsets]
    scaled_offsets, scaled_terms = scaled_plan(off_list)
    return DIAPattern(
        offsets=tuple(off_list),
        ndof=ndof,
        flat_map=flat_map.astype(np.int64),
        nnz=len(rows) * 16,
        scaled_offsets=scaled_offsets,
        scaled_terms=scaled_terms,
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


def _shift(v: torch.Tensor, e: int) -> torch.Tensor:
    """shift(v, e)[i] = v[i + e], zero where i + e leaves [0, n)."""
    if e == 0:
        return v
    out = torch.zeros_like(v)
    if e > 0:
        out[:-e] = v[e:]
    else:
        out[-e:] = v[:e]
    return out


def scale_rows_dia(pattern: DIAPattern, data: torch.Tensor,
                   inv_blocks: torch.Tensor) -> tuple:
    """S = D^{-1} A in DIA form, folding block-Jacobi into the operator so
    each left-preconditioned GMRES iteration is one SpMV.  With the static
    plan of `pattern`:

        S_data[t][i] = sum_e  Dinv[i, i+e] * data[k_{t-e}][i + e]

    inv_blocks: (nb, 4, 4) inverted diagonal blocks.  Returns
    (scaled_offsets, scaled_data (K', ndof))."""
    invd = block_diag_to_dia(inv_blocks).data            # (7, ndof), e = k-3
    out = []
    for terms in pattern.scaled_terms:
        acc = None
        for e, k in terms:
            term = invd[e + 3] * _shift(data[k], e)
            acc = term if acc is None else acc + term
        out.append(acc)
    return pattern.scaled_offsets, torch.stack(out)


DINV_OFFSETS = tuple(range(-3, 4))    # the block-diagonal D^{-1} in DIA form


def block_diag_to_dia(blocks: torch.Tensor) -> ScalarDIA:
    """(nb, 4, 4) block-diagonal matrix -> 7-diagonal ScalarDIA (offsets
    -3..3): the block-Jacobi apply is itself a scalar-DIA SpMV."""
    nb = blocks.shape[0]
    data = torch.zeros((7, 4 * nb), dtype=blocks.dtype, device=blocks.device)
    for a in range(4):
        for b in range(4):
            data[b - a + 3, a::4] = blocks[:, a, b]
    return ScalarDIA(offsets=DINV_OFFSETS, data=data, nnz=nb * 16)
