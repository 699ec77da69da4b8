"""GMRES iterations per step (NewtonStats.lin_iters), over every step of
the window."""

UNIT, SOURCE = "it/step", "program_counter"
LAYER = "GMRES (solvers/gmres.py)"
MOVES = "step_ms_p95"


def read(r):
    return r.window.gmres / r.window.steps
