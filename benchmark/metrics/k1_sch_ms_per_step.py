"""Device time of K1's kernels in the traced segments, per step, on the
Schur tier: its four forms (4x4, F 3x3, A_pu 1x3, S_hat 1x1) together,
read as `k1_ms_per_step` reads K1."""

from benchmark.metrics.k1_ms_per_step import read  # noqa: F401

UNIT, SOURCE = "ms/step", "device_trace"
LAYER = "kernel K1 (ops/plane_dia.py, csrc/plane_dia.cu)"
MOVES = "step_ms_p95"
