"""TF32 off for the solver's own work, and only there.

TF32 would round the operands of an f32 matrix product (the coarse GEMV,
the CGS2 projection) to 10 mantissa bits: the H100 counterpart of the
TPU's bf16 matmul trap (181 against 69 GMRES iterations per step,
benchlogs/transient_scaling.txt).  The solver turns it off around its own
work and gives the caller's two flags back on the way out, so that
building or running a solver changes no process-wide state.
"""

from __future__ import annotations

import functools

import torch


class tf32_off:
    """Context manager: `torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32` read False inside; the caller's
    values come back on exit, also when an exception leaves.  Where both
    are False already (every nested use inside the solver) it touches
    nothing."""

    __slots__ = ("_saved",)

    def __enter__(self):
        matmul = torch.backends.cuda.matmul.allow_tf32
        cudnn = torch.backends.cudnn.allow_tf32
        self._saved = (matmul, cudnn) if (matmul or cudnn) else None
        if self._saved is not None:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self._saved
        return False


def no_tf32(fn):
    """`fn` run inside `tf32_off`."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with tf32_off():
            return fn(*args, **kwargs)
    return run


def no_tf32_operators(prep_operators):
    """For a solver's `_prep_operators`: every callable of the (matvec,
    b_prep, parts) it returns runs inside `tf32_off`."""
    @functools.wraps(prep_operators)
    def wrapped(*args, **kwargs):
        matvec, b_prep, parts = prep_operators(*args, **kwargs)
        return (no_tf32(matvec), no_tf32(b_prep),
                {name: no_tf32(fn) for name, fn in parts.items()})
    return wrapped
