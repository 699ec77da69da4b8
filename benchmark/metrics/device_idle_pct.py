"""Share of the traced segments in which no operation ran on the device:
1 - (union of kernel, copy and fill intervals) / traced window."""

UNIT, SOURCE = "%", "device_trace"
LAYER = "device"
MOVES = "step_ms_p95"


def read(r):
    if not r.trace or not r.trace["window_s"]:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
