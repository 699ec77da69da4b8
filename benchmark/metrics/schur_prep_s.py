"""Host seconds of the Schur tier's algebra (SchurPrep.seconds) in the
Newton preparation, which set-up's `prep_s` runs once (the Stokes
preparation runs the same stages on the Stokes operator and is not held
by the solver); nothing where the run builds no Schur preparation."""

UNIT, SOURCE = "s", "program_counter"
LAYER = "Schur host algebra (solvers/schur.py)"
MOVES = "setup_s"


def read(r):
    if not r.schur_seconds:
        return None
    return sum(r.schur_seconds.values())
