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

The control (`round_below`) is the same answers rounded to the precision
next below the configuration's: TF32's 10-bit mantissa for float32 with
TF32 off (`round_tf32`), float32 for float64; it has to come out not
correct.  The reference solves nothing (it reads residuals of given
answers), so the control is not a solve at that precision but the answers
as it holds them: the least error that any computation returning such
values has.
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


def round_below(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """The answers `x` at the precision next below the configuration's
    `dtype`: TF32 for float32, float32 (carried in float64) for float64."""
    if dtype == "float32":
        return round_tf32(x)
    if dtype == "float64":
        return x.to(torch.float32).to(torch.float64)
    raise ValueError(f"no precision below {dtype!r} is defined")


def readings(reference, stokes_state, pairs, control: str | None = None
             ) -> dict:
    """The three numbers for these answers; with `control` (the
    configuration's dtype) for the answers rounded below it."""
    if control is not None:
        stokes_state = round_below(stokes_state, control)
        pairs = [(old, round_below(new, control)) for old, new in pairs]
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
