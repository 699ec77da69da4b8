"""Preconditioners of the block-CSR route: block-Jacobi and the ILU(k)
host oracle.

Block-Jacobi is batched exact 4x4 block inverses, optionally wrapped in a
truncated Neumann series:

  M^{-1} = sum_{i<=order} (I - D^{-1} A)^i D^{-1}     (order 0 = plain Jacobi)

The block ILU(k) of the reference (`src/solve_newton.c:1159-1162`,
`src/kernels/baij4_solve*.c`) is kept as a numpy correctness oracle on the
host, as in the JAX package: its sequential triangular solves are no
device kernel.  Solver-level parity with ILU is "same converged solution,
another iteration count".  The model's `preconditioner='ilu0'` is not
this oracle: see `config.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from navierstokes_tpu_torch.ops.block import block4_apply, block4_inverse
from navierstokes_tpu_torch.sparse.bcsr import BCSR4


@dataclasses.dataclass
class BlockJacobiPreconditioner:
    """M^{-1} = blockdiag(A_ii)^{-1}, optionally Neumann-boosted."""

    inv_diag: torch.Tensor                # (nb, 4, 4)
    matvec: Optional[Callable] = None     # required if order > 0
    order: int = 0

    @classmethod
    def from_bcsr(cls, m: BCSR4, diag_slots, matvec=None, order=0):
        diag = m.values[torch.as_tensor(diag_slots, dtype=torch.int64,
                                        device=m.values.device)]
        return cls(inv_diag=block4_inverse(diag, pivot_eps=1e-300,
                                           shift=1e-8),
                   matvec=matvec, order=order)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        acc = block4_apply(self.inv_diag, r)
        for _ in range(self.order):
            # z_{i+1} = z_i + D^{-1}(r - A z_i): the Neumann refinement
            acc = acc + block4_apply(self.inv_diag, r - self.matvec(acc))
        return acc


def _ilu_symbolic_fill(indptr, indices, nb: int, level: int) -> tuple:
    """Level-of-fill symbolic ILU(k) pattern on the block graph.

    Original entries have level 0; a fill entry (i, j) created through
    pivot column c gets level lev(i,c) + lev(c,j) + 1 and is kept iff <=
    `level` (PETSc's `PCFactorSetLevels`, `src/solve_newton.c:1162`).
    Returns (indptr, indices) with the fill."""
    rows = [{int(indices[s]): 0 for s in range(indptr[i], indptr[i + 1])}
            for i in range(nb)]
    for i in range(nb):
        row = rows[i]
        for c in sorted(c for c in row if c < i):
            lev_ic = row[c]
            if lev_ic > level:
                continue
            for j, lev_cj in rows[c].items():
                if j <= c:
                    continue
                lev = lev_ic + lev_cj + 1
                if lev <= level and (j not in row or row[j] > lev):
                    row[j] = min(row.get(j, lev), lev)
        rows[i] = {c: lv for c, lv in row.items() if lv <= level}
    new_indptr = np.zeros(nb + 1, dtype=np.int64)
    new_indices = []
    for i in range(nb):
        cols = sorted(rows[i])
        new_indices.extend(cols)
        new_indptr[i + 1] = new_indptr[i] + len(cols)
    return new_indptr, np.asarray(new_indices, dtype=np.int64)


class ILU0Preconditioner:
    """Block ILU(k) on the BCSR4 pattern: the host numpy oracle.

    The IKJ block factorization on the level-k fill pattern (level 0 is
    ILU(0)), diagonal blocks stored inverted (as PETSc's factored BAIJ),
    in float64.  The solves are sequential forward and backward block
    substitutions on the host; `__call__` takes a tensor from its device
    to the host and back."""

    def __init__(self, m: BCSR4, level: int = 0):
        nb = m.nb
        src = m.values.detach().cpu().numpy().astype(np.float64)
        if level > 0:
            indptr, indices = _ilu_symbolic_fill(m.indptr, m.indices, nb,
                                                 level)
            vals = np.zeros((len(indices), 4, 4), dtype=np.float64)
            for i in range(nb):
                lo, hi = indptr[i], indptr[i + 1]
                row_cols = indices[lo:hi]
                for s in range(m.indptr[i], m.indptr[i + 1]):
                    vals[lo + np.searchsorted(row_cols, m.indices[s])] = \
                        src[s]
            self.indptr, self.indices = indptr, indices
        else:
            self.indptr, self.indices = m.indptr, m.indices
            vals = src.copy()
        indptr, indices = self.indptr, self.indices
        row_slots = [{int(indices[s]): s
                      for s in range(indptr[r], indptr[r + 1])}
                     for r in range(nb)]
        for i in range(nb):
            for s in range(indptr[i], indptr[i + 1]):
                k = int(indices[s])
                if k >= i:
                    continue
                # L_ik = A_ik inv(U_kk) (U_kk is stored inverted already)
                vals[s] = vals[s] @ vals[row_slots[k][k]]
                a_ik = vals[s]
                for s2 in range(row_slots[k][k] + 1, indptr[k + 1]):
                    sij = row_slots[i].get(int(indices[s2]))
                    if sij is not None:
                        vals[sij] = vals[sij] - a_ik @ vals[s2]
            di = row_slots[i][i]
            vals[di] = np.linalg.inv(vals[di])
        self.vals = vals
        self.row_slots = row_slots
        self.nb = nb

    def solve_host(self, r: np.ndarray) -> np.ndarray:
        """x = (LU)^{-1} r with unit-diagonal L and inverted-diagonal U."""
        nb = self.nb
        r4 = np.asarray(r, dtype=np.float64).reshape(nb, 4)
        indptr, indices, vals = self.indptr, self.indices, self.vals
        y = np.zeros_like(r4)
        for i in range(nb):
            acc = r4[i].copy()
            for s in range(indptr[i], indptr[i + 1]):
                j = int(indices[s])
                if j < i:
                    acc -= vals[s] @ y[j]
            y[i] = acc
        x = np.zeros_like(r4)
        for i in range(nb - 1, -1, -1):
            acc = y[i].copy()
            for s in range(indptr[i], indptr[i + 1]):
                j = int(indices[s])
                if j > i:
                    acc -= vals[s] @ x[j]
            x[i] = vals[self.row_slots[i][i]] @ acc
        return x.reshape(-1)

    def solve_host_transpose(self, r: np.ndarray) -> np.ndarray:
        """x = (LU)^{-T} r: (LU)^T = U^T L^T, so a forward sweep with U^T
        (its stored inverted diagonal transposes into U^T's), then a
        backward sweep with the unit-diagonal L^T, each scattering the
        computed block down or up the columns (the reference's
        MatSolveTranspose, `src/kernels/baij4_factor_avx2.c:399-498`)."""
        nb = self.nb
        indptr, indices, vals = self.indptr, self.indices, self.vals
        work = np.array(np.asarray(r, dtype=np.float64).reshape(nb, 4))
        y = np.zeros_like(work)
        for i in range(nb):                      # U^T y = r (forward)
            di = self.row_slots[i][i]
            y[i] = vals[di].T @ work[i]
            for s in range(di + 1, indptr[i + 1]):
                work[int(indices[s])] -= vals[s].T @ y[i]
        x = np.zeros_like(work)
        for i in range(nb - 1, -1, -1):          # L^T x = y (backward)
            x[i] = y[i]
            for s in range(indptr[i], indptr[i + 1]):
                j = int(indices[s])
                if j >= i:
                    break
                y[j] -= vals[s].T @ x[i]
        return x.reshape(-1)

    def __call__(self, r: torch.Tensor,
                 transpose: bool = False) -> torch.Tensor:
        solve = self.solve_host_transpose if transpose else self.solve_host
        x = solve(r.detach().cpu().numpy())
        return torch.as_tensor(x).to(device=r.device, dtype=r.dtype)


# ILU with levels is the same class, under the JAX package's second name.
ILUPreconditioner = ILU0Preconditioner


def make_preconditioner(kind: str, m: BCSR4, diag_slots, matvec=None,
                        order: int = 0, level: int = 0):
    if kind == "none" or kind is None:
        return None
    if kind == "block_jacobi":
        return BlockJacobiPreconditioner.from_bcsr(m, diag_slots,
                                                   matvec=matvec, order=order)
    if kind == "ilu0":
        return ILU0Preconditioner(m, level=0)
    if kind == "ilu":
        return ILU0Preconditioner(m, level=level)
    raise ValueError(f"unknown preconditioner {kind!r}")
