"""Device time of K1's kernels in the traced segments, per step."""

from benchmark.kernels import K1_KERNEL

UNIT, SOURCE = "ms/step", "device_trace"
LAYER = "kernel K1 (ops/plane_dia.py, csrc/plane_dia.cu)"
MOVES = "step_ms_p95"


def read(r):
    if not r.trace or not r.window.traced_steps:
        return None
    us = sum(d for name, d in r.trace["kernels"] if K1_KERNEL in name)
    return us * 1e-3 / r.window.traced_steps if us else None
