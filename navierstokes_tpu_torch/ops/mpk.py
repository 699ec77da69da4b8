"""Matrix powers by chained SpMVs: A^k x, [A x, ..., A^k x] and the
monomial Krylov basis, as in the JAX package's `ops/mpk.py`.

Each apply is the scalar-DIA SpMV `ops/dia.spmv_dia` (kernel K2 on the
card).  The one-sweep fused A^p x is `ops/mpk_fused.spmpv_dia` (K4).
"""

from __future__ import annotations

import torch

from navierstokes_tpu_torch.ops.dia import spmv_dia


def matrix_power(offsets, data, x, k: int, *, spmv=spmv_dia):
    """A^k x by k chained SpMVs `spmv(offsets, data, y)`: K2 by default; a
    caller may chain another form of the same operator (its plain version,
    or another layout's SpMV with that layout's offsets and data)."""
    y = x
    for _ in range(k):
        y = spmv(offsets, data, y)
    return y


def matrix_powers_all(offsets, data, x, k: int):
    """[A x, A^2 x, ..., A^k x] stacked along axis 1: (ndof, k)."""
    ys = []
    y = x
    for _ in range(k):
        y = spmv_dia(offsets, data, y)
        ys.append(y)
    return torch.stack(ys, dim=1)


def krylov_basis(offsets, data, v, s: int, *, normalize: bool = False):
    """Monomial Krylov basis [v, Av, ..., A^s v]: (ndof, s+1).  With
    normalize=True each column is scaled to unit norm as it is produced."""
    cols = [v]
    y = v
    for _ in range(s):
        y = spmv_dia(offsets, data, y)
        if normalize:
            y = y / torch.linalg.norm(y)
        cols.append(y)
    return torch.stack(cols, dim=1)
