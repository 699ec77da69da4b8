"""Timing for the port's benchmarks, as the JAX package's `bench/timing.py`.

Applications are chained data-dependently (each output, normalized by its
max |value|, feeds the next input), so no two of them overlap, and the
time per application is the slope between two trip counts, which removes
the fixed cost of starting and ending a measurement.  On the card the
chain is timed with CUDA events; on the CPU with the host clock.  Best of
N repeats, as the reference's `src/main.c:127-137`.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def chained_op_time(step_fn, x0: torch.Tensor, operands=(), r1: int = 16,
                    best_of: int = 3, min_delta: float = 0.05) -> float:
    """Seconds per application of `step_fn(v, *operands)`.

    The pair of trip counts grows (4x at a time) until the longer chain
    takes `min_delta` seconds more than the shorter one."""
    cuda = x0.device.type == "cuda"

    def chain(n: int) -> torch.Tensor:
        v = x0
        for _ in range(n):
            y = step_fn(v, *operands)
            v = y / torch.clamp(y.abs().max(), min=1e-30)
        return v

    def measure(n: int) -> float:
        best = float("inf")
        for _ in range(best_of):
            if cuda:
                torch.cuda.synchronize(x0.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                chain(n)
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) * 1e-3
            else:
                t0 = time.perf_counter()
                chain(n)
                t = time.perf_counter() - t0
            best = min(best, t)
        return best

    chain(4)                                    # warm-up (and first build)
    if cuda:
        torch.cuda.synchronize(x0.device)
    r2 = 4 * r1
    t1, t2 = measure(r1), measure(r2)
    while t2 - t1 < min_delta and r2 < 600_000:
        r1, t1 = r2, t2
        r2 = 4 * r2
        t2 = measure(r2)
    return (t2 - t1) / (r2 - r1)


def rel_error(y, y_ref) -> float:
    """Relative L2 error (`mpk/utils.cpp:131-143`), in float64."""
    y = np.asarray(y, dtype=np.float64)
    y_ref = np.asarray(y_ref, dtype=np.float64)
    denom = np.linalg.norm(y_ref)
    return float(np.linalg.norm(y - y_ref) / denom) if denom else float("nan")
