"""The comparison that decides `correct`.

Three numbers, each read by the plain reference (`benchmark/reference`)
from answers the timed path produced, each against a limit of its own in
the cell's file (`limits`), set from two readings (PERF.md):

  step_res    the largest, over the checked steps, of
              |F(u_new)| / max(rtol |F(u_old)|, atol) on the free rows;
  bc_err      the largest |u - g| over the constrained DoF of the checked
              steps' answers;
  stokes_res  |b - A_s x| / |b| of the Stokes state the segments start
              from: the true residual, which the Stokes GMRES tolerance
              bounds only through the left preconditioner (it stops on
              |M^-1 (b - A_s x)|), so its limit is set between readings.

The control (`round_tf32`) is the same answers carried at TF32's 10-bit
mantissa, the precision next below the configuration's float32 with TF32
off; it has to come out not correct.  The reference solves nothing (it
reads residuals of given answers), so the control is not a TF32 solve but
the answers as TF32 holds them: the least error that any computation
returning TF32 values has.
"""

from __future__ import annotations

import torch

NAMES = ("step_res", "bc_err", "stokes_res")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits), to nearest even."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    lsb = (bits >> 13) & 1
    bits = ((bits + 0xFFF + lsb) >> 13) << 13
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def readings(reference, stokes_state, pairs, control: bool = False) -> dict:
    """The three numbers for these answers (TF32-rounded with `control`)."""
    if control:
        stokes_state = round_tf32(stokes_state)
        pairs = [(old, round_tf32(new)) for old, new in pairs]
    return {
        "step_res": max(reference.step_residuals(pairs)),
        "bc_err": max(reference.bc_errors([new for _, new in pairs])),
        "stokes_res": reference.stokes_residual(stokes_state),
    }


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct where every number is
    at or below its limit (a missing limit fails)."""
    out = {n: {"value": numbers[n], "limit": limits.get(n)} for n in NAMES}
    ok = all(v["limit"] is not None and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
