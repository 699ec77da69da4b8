"""The benchmark's span around NavierStokesSolver(...) and
_ensure_prepared(): discretization, assembly, the Newton operator's
preparation."""

UNIT, SOURCE = "s", "program_span"
LAYER = ("solver set-up (model/navier_stokes.py: NavierStokesSolver, "
         "_ensure_prepared)")
MOVES = "setup_s"


def read(r):
    return r.spans["prep_s"]
