"""Blocked sparse matrix-vector products and the variant dispatch of the
JAX package's `ops/spmv.py`.

- `spmv_bcsr_ref`: a segment sum over the 4x4 BCSR blocks, the oracle
  every other variant is checked against.
- `spmv_bell`, `spmv_bell_multi`: the block-ELL product (`sparse/bell.py`)
  as a gather of x's 4-vectors and a batched 4x4 product, summed over the
  slots; `spmv_bell_windowed` the same with each tile of rows gathering
  from its own window of x (`compute_window_starts`).  Plain PyTorch, as
  in the JAX package, where XLA's gather and einsum compute it: no Pallas
  kernel reaches the block-ELL product.
- `spmv_dia`: the scalar-DIA product, kernel-free on any device (K2's
  plain version).
- `make_spmv`: the runtime variant choice by name; `'pallas_dia'` is
  kernel K2 (`ops/dia.py`); `'dia'` and `'dia_bf16'` (the operator stored
  in bfloat16) are the kernel-free XLA formulation, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch.ops import dia as dia_ops


def spmv_bcsr_ref(row_ids: torch.Tensor, indices: torch.Tensor,
                  values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Oracle SpMV.  row_ids, indices: (nnzb,) block coordinates;
    values: (nnzb, 4, 4); x: (4*nb,)."""
    nb = x.shape[0] // 4
    contrib = torch.einsum("kab,kb->ka", values, x.reshape(nb, 4)[indices])
    y4 = torch.zeros((nb, 4), dtype=contrib.dtype, device=x.device)
    y4.index_add_(0, row_ids, contrib)
    return y4.reshape(-1)


def bell_rows(values: torch.Tensor, gathered: torch.Tensor) -> torch.Tensor:
    """sum_s values[r, s] @ gathered[r, s] -> (rows, 4, ...): one 4x4
    product per slot, then the sum over the slots (no copy of values)."""
    return torch.matmul(values, gathered).sum(1)


def spmv_bell(indices: torch.Tensor, values: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMV: y[r] = sum_s values[r, s] @ x4[indices[r, s]].

    indices: (nb, S) integer tensor, values: (nb, S, 4, 4), x: (4 nb,)."""
    nb = indices.shape[0]
    gathered = x.reshape(nb, 4)[indices]                    # (nb, S, 4)
    return bell_rows(values, gathered[..., None]).reshape(-1)


def spmv_bell_multi(indices: torch.Tensor, values: torch.Tensor,
                    X: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMM against a multivector X: (4 nb, m) -> (4 nb, m), the
    s-step Krylov basis building block."""
    nb = indices.shape[0]
    m = X.shape[1]
    gathered = X.reshape(nb, 4, m)[indices]                 # (nb, S, 4, m)
    return bell_rows(values, gathered).reshape(4 * nb, m)


def spmv_bell_windowed(indices: torch.Tensor, values: torch.Tensor,
                       x: torch.Tensor, *, tile: int, window_starts,
                       window: int) -> torch.Tensor:
    """Row-tiled block-ELL SpMV with windowed access to x.

    For each tile t of `tile` block rows, every column must lie in
    [window_starts[t], window_starts[t] + window): the columns are rebased
    into the window and gathered from that slice of x.  All tiles go in
    one batched gather.  nb must be a multiple of `tile`."""
    nb, s = indices.shape
    if nb % tile:
        raise ValueError(f"nb={nb} is not a multiple of tile={tile}")
    nt = nb // tile
    starts = torch.as_tensor(np.asarray(window_starts), dtype=torch.int64,
                             device=x.device)
    x4 = x.reshape(nb, 4)
    xw = x4[starts[:, None] + torch.arange(window, device=x.device)]
    local = indices.reshape(nt, tile, s) - starts[:, None, None]
    tiles = torch.arange(nt, device=x.device)[:, None, None]
    gathered = xw[tiles, local]                             # (nt, tile, S, 4)
    return bell_rows(values, gathered.reshape(nb, s, 4, 1)).reshape(-1)


def compute_window_starts(indices: np.ndarray, tile: int,
                          window: int) -> np.ndarray:
    """Host side: the window start of each tile, so that all of the tile's
    columns fit in `window` (a ValueError names the first tile whose span
    does not)."""
    nb, _ = indices.shape
    nt = nb // tile
    per_tile = np.asarray(indices[:nt * tile]).reshape(nt, -1)
    cmin = per_tile.min(axis=1).astype(np.int64)
    span = per_tile.max(axis=1).astype(np.int64) - cmin + 1
    bad = np.flatnonzero(span > window)
    if len(bad):
        t = int(bad[0])
        raise ValueError(f"tile {t}: column span {int(span[t])} exceeds "
                         f"window {window}")
    return np.minimum(np.maximum(cmin, 0), nb - window).astype(np.int32)


# The scalar-DIA SpMV in its kernel-free form (the JAX package's XLA
# formulation `spmv_dia`) is K2's plain version.
spmv_dia = dia_ops.spmv_dia_plain


SPMV_VARIANTS = ("oracle", "ell", "dia", "dia_bf16", "pallas_dia")


def make_spmv(variant: str, *, bcsr=None, ell=None, dia=None):
    """Runtime SpMV variant dispatch by name, returning y = A x.

    bcsr: (row_ids, indices, values) tensors for 'oracle'; ell: a
    `BlockELL` for 'ell'; dia: a `ScalarDIA` for 'dia', 'dia_bf16' and
    'pallas_dia' ('pallas_dia' is K2; 'dia_bf16' casts the data to
    bfloat16 once and returns x's dtype)."""
    if variant == "oracle":
        row_ids, indices, values = bcsr
        return lambda x: spmv_bcsr_ref(row_ids, indices, values, x)
    if variant == "ell":
        idx = torch.as_tensor(ell.indices, dtype=torch.int64,
                              device=ell.values.device)
        return lambda x: spmv_bell(idx, ell.values, x)
    if variant == "dia":
        return lambda x: spmv_dia(dia.offsets, dia.data, x)
    if variant == "pallas_dia":
        return lambda x: dia_ops.spmv_dia(dia.offsets, dia.data, x)
    if variant == "dia_bf16":
        data16 = dia.data.to(torch.bfloat16)
        return lambda x: spmv_dia(dia.offsets, data16, x)
    raise ValueError(f"unknown spmv variant {variant!r}; one of "
                     f"{SPMV_VARIANTS}")
