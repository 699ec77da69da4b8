"""Kernels the device ran in the traced segments, per step."""

UNIT, SOURCE = "count/step", "device_trace"
LAYER = "device (launch path)"
MOVES = "step_ms_p95"


def read(r):
    if not r.trace or not r.window.traced_steps or not r.trace["kernels"]:
        return None
    return len(r.trace["kernels"]) / r.window.traced_steps
