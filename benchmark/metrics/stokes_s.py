"""The benchmark's span around stokes_init(): the Stokes operator, its
preparation and the Stokes GMRES solve."""

UNIT, SOURCE = "s", "program_span"
LAYER = "Stokes init (model/navier_stokes.py: stokes_init)"
MOVES = "setup_s"


def read(r):
    return r.spans["stokes_s"]
