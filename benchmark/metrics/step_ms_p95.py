"""95th percentile of the window's step times, each on the host clock up
to the step's final device sync."""

import numpy as np

UNIT, LAYER, MOVES, SOURCE = "ms", None, None, "host_clock"


def read(r):
    return float(np.percentile(r.window.step_seconds, 95)) * 1e3
