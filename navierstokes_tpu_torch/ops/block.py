"""Small dense block operations.

The 4x4 unpivoted Gauss–Jordan inverse with the reference's zero-pivot
emergency shift (`src/kernels/baij4_factor_avx2.c:7-58,283-290`), batched
over a leading dimension.
"""

from __future__ import annotations

import torch


def block4_inverse(blocks: torch.Tensor, pivot_eps: float = 0.0,
                   shift: float = 1e-8) -> torch.Tensor:
    """Batched inverse of (..., 4, 4) blocks by unpivoted Gauss–Jordan.

    A pivot with |pivot| < pivot_eps gets +shift.  Both constants are taken
    in the blocks' dtype, as JAX takes a weakly typed scalar: in float32
    the default pivot_eps=1e-300 of the operator preparation rounds to 0,
    so no shift ever fires there."""
    dtype, device = blocks.dtype, blocks.device
    eps = torch.tensor(pivot_eps, dtype=dtype, device=device)
    sh = torch.tensor(shift, dtype=dtype, device=device)
    flat = blocks.reshape(-1, 4, 4)
    eye = torch.eye(4, dtype=dtype, device=device).expand(flat.shape[0], 4, 4)
    aug = torch.cat([flat, eye], dim=2)                  # (N, 4, 8)
    for k in range(4):
        pivot = aug[:, k, k]
        pivot = torch.where(pivot.abs() < eps, pivot + sh, pivot)
        row = aug[:, k] / pivot[:, None]
        aug = aug.clone()
        aug[:, k] = row
        factors = aug[:, :, k].clone()
        factors[:, k] = 0.0
        aug = aug - factors[:, :, None] * row[:, None, :]
    return aug[:, :, 4:].reshape(blocks.shape)


def block4_apply(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-diagonal apply: (nb, 4, 4) blocks times an interleaved (4 nb,)
    vector."""
    return (blocks @ x.reshape(-1, 4, 1)).reshape(-1)
