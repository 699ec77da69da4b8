"""Wall time of the window over the steps completed in it, the traced
segment (whose host time the profiler doubles) left out.  Per layer: the
host's own speed spreads it too widely between runs for a bound."""

UNIT, SOURCE = "ms", "host_clock"
LAYER = "whole step (model/navier_stokes.py: NavierStokesSolver.step)"
MOVES = "step_ms_p95"


def read(r):
    w = r.window
    steps = w.steps - w.traced_steps
    if steps <= 0:
        return None
    return (w.seconds - w.traced_seconds) / steps * 1e3
