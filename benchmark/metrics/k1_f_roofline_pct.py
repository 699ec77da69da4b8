"""K1's share of its roofline on F, the Schur tier's 3x3 velocity block:
`benchmark/k1_form.py`."""

from benchmark.k1_form import roofline_pct

UNIT, SOURCE = "%", "device_trace"
LAYER = "kernel K1 (ops/plane_dia.py, csrc/plane_dia.cu)"
MOVES = "step_ms_p95"


def read(r):
    return roofline_pct(r, 3, 3)
