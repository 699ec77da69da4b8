"""Host waits on the device per step in the traced segment: the program's
always-on counter `syncs` (every `utils/profiling.fetch` and `wait`) over
that segment, over its steps."""

UNIT, SOURCE = "count/step", "program_counter"
LAYER = "host-device boundary (utils/profiling.fetch, wait)"
MOVES = "step_ms_p95"


def read(r):
    if "syncs" not in r.counters or not r.window.traced_steps:
        return None
    return r.counters["syncs"] / r.window.traced_steps
