"""Scatter-adds whose sums do not depend on the run.

CUDA's `index_add_` adds colliding entries with atomics, in an order that
changes from run to run, so an assembled operator (and the coarse matrix
built from it) differs in its last bits between runs.  Those bits decide
where GMRES and Newton stop, so with atomics the f64 golden-trajectory
check in flagship mode gave a different error in every run, some of them
close to its bar (PERF.md).  With a fixed order a run repeats bit for
bit.
"""

from __future__ import annotations

import torch


def index_add_fixed_order(out: torch.Tensor, index: torch.Tensor,
                          values: torch.Tensor) -> torch.Tensor:
    """`out.index_add_(0, index, values)` with the adds in a fixed order.

    PyTorch's deterministic mode routes `index_add_` on the card through
    its sorted, accumulating `index_put_`; the mode is switched on for
    this call only and restored after it.  On the CPU `index_add_` is
    sequential already."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return out.index_add_(0, index, values)
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn_only)
