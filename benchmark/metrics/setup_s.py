"""Process start to the first timed step: mesh, solver build and
preparation, Stokes, the lead-in steps and the warm segment."""

UNIT, LAYER, MOVES, SOURCE = "s", None, None, "host_clock"


def read(r):
    return r.setup_s
