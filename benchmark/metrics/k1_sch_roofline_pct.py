"""K1's least time over its device time in the traced segments, over all
forms of the Schur tier: `k1_roofline_pct`'s formula."""

from benchmark.metrics.k1_roofline_pct import read  # noqa: F401

UNIT, SOURCE = "%", "device_trace"
LAYER = "kernel K1 (ops/plane_dia.py, csrc/plane_dia.cu)"
MOVES = "step_ms_p95"
