"""K1's share of its roofline on S_hat, the Schur tier's 1x1 form (on the
sumset of the node offsets, 65 on a box mesh): `benchmark/k1_form.py`."""

from benchmark.k1_form import roofline_pct

UNIT, SOURCE = "%", "device_trace"
LAYER = "kernel K1 (ops/plane_dia.py, csrc/plane_dia.cu)"
MOVES = "step_ms_p95"


def read(r):
    return roofline_pct(r, 1, 1)
