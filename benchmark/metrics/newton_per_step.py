"""Newton iterations per step (NewtonStats.iters), over every step of the
window."""

UNIT, SOURCE = "it/step", "program_counter"
LAYER = "Newton loop (model/navier_stokes.py)"
MOVES = "step_ms_p95"


def read(r):
    return r.window.newton / r.window.steps
