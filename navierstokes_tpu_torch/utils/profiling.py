"""Profiling hooks, as in the JAX package (the reference's PETSc log
events and `-log_view`).

- `EventLog`: wall time of named events, with optional flop counts, and a
  `-log_view`-style table.  An event given a CUDA tensor as `sync_result`
  ends with `torch.cuda.synchronize`, so it brackets the device work and
  not only its enqueue.
- `trace(logdir)`: a `torch.profiler` trace of CPU and CUDA activity,
  written as a Chrome trace (`trace.json`) under `logdir`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class EventLog:
    def __init__(self):
        self._count = defaultdict(int)
        self._total = defaultdict(float)
        self._flops = defaultdict(float)

    @contextlib.contextmanager
    def event(self, name: str, flops: float = 0.0, sync_result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_result is not None and sync_result.device.type == "cuda":
                torch.cuda.synchronize(sync_result.device)
            self._count[name] += 1
            self._total[name] += time.perf_counter() - t0
            self._flops[name] += flops

    def log_flops(self, name: str, flops: float) -> None:
        self._flops[name] += flops

    def report(self) -> str:
        """The events by total time: count, seconds, ms per event,
        GFLOP/s."""
        lines = [f"{'Event':<28}{'Count':>8}{'Time (s)':>12}{'Avg (ms)':>12}"
                 f"{'GFLOP/s':>10}"]
        for name in sorted(self._total, key=lambda n: -self._total[n]):
            cnt, tot = self._count[name], self._total[name]
            gfs = self._flops[name] / tot / 1e9 if tot > 0 else 0.0
            lines.append(f"{name:<28}{cnt:>8}{tot:>12.4f}"
                         f"{1e3 * tot / max(cnt, 1):>12.3f}{gfs:>10.2f}")
        return "\n".join(lines)

    def totals(self) -> dict:
        return dict(self._total)


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the body with `torch.profiler` (CPU, and CUDA where there is
    a card) into `logdir/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
