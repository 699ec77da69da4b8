"""Blocked sparse matrix-vector products: the oracle and the variant
dispatch of the JAX package's `ops/spmv.py`.

- `spmv_bcsr_ref`: a segment sum over the 4x4 BCSR blocks, the oracle
  every other variant is checked against.
- `spmv_dia`: the scalar-DIA product, kernel-free on any device (K2's
  plain version).
- `make_spmv`: the runtime variant choice by name; `'pallas_dia'` is
  kernel K2 (`ops/dia.py`); `'dia'` and `'dia_bf16'` (the operator stored
  in bfloat16) are the kernel-free XLA formulation, as in the JAX package.
"""

from __future__ import annotations

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


# The scalar-DIA SpMV in its kernel-free form (the JAX package's XLA
# formulation `spmv_dia`) is K2's plain version.
spmv_dia = dia_ops.spmv_dia_plain


SPMV_VARIANTS = ("oracle", "ell", "dia", "dia_bf16", "pallas_dia")


def make_spmv(variant: str, *, bcsr=None, dia=None):
    """Runtime SpMV variant dispatch by name, returning y = A x.

    bcsr: (row_ids, indices, values) tensors for 'oracle'; dia: a
    `ScalarDIA` for 'dia', 'dia_bf16' and 'pallas_dia' ('pallas_dia' is K2;
    'dia_bf16' casts the data to bfloat16 once and returns x's dtype)."""
    if variant == "oracle":
        row_ids, indices, values = bcsr
        return lambda x: spmv_bcsr_ref(row_ids, indices, values, x)
    if variant == "dia":
        return lambda x: spmv_dia(dia.offsets, dia.data, x)
    if variant == "pallas_dia":
        return lambda x: dia_ops.spmv_dia(dia.offsets, dia.data, x)
    if variant == "ell":
        raise NotImplementedError(
            "spmv variant 'ell' is not ported to navierstokes_tpu_torch yet "
            "(ROADMAP slice 16: sparse/bell.py)")
    if variant == "dia_bf16":
        data16 = dia.data.to(torch.bfloat16)
        return lambda x: spmv_dia(dia.offsets, data16, x)
    raise ValueError(f"unknown spmv variant {variant!r}; one of "
                     f"{SPMV_VARIANTS}")
