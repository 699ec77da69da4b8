"""The one generator of the benchmark's traffic: replayed segments of
backward-Euler steps.

A cell's file gives its parameters: `start_step` (steps run in set-up
before the start state is taken), `segment_steps`, the seeded
`perturbation` of the start state and `max_checks` (how many answers the
comparison reads at most).  Every segment starts from the same start state with
u_old = u and delta_u = 0, so the work of a step does not depend on how
fast the program is, and segments repeat until the window's seconds have
passed; the segment in progress then is finished and counted.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch


def seeded_rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one use of the seed (any whole number)."""
    words = [ord(c) for c in stream]
    return np.random.default_rng([abs(int(seed)), int(seed < 0), *words])


def perturbation(coords: np.ndarray, free: np.ndarray, params: dict,
                 seed: int) -> np.ndarray:
    """A smooth field on the free velocity DoF, (4 nv,) float64.

    Each velocity component is a sum of `modes` products of sines over the
    bounding box, wave numbers 1..`max_wavenumber`, with phases and weights
    from the seed; the field is scaled so that its root mean square over
    the free velocity DoF is `amplitude`.  Every seed gives a field of the
    same size and smoothness, so the seed changes the shape, not the
    work."""
    rng = seeded_rng(seed, "perturbation")
    if not params["amplitude"]:
        return np.zeros(4 * coords.shape[0])
    lo, hi = coords.min(0), coords.max(0)
    xi = (coords - lo) / np.where(hi > lo, hi - lo, 1.0)       # (nv, 3)
    nv = coords.shape[0]
    field = np.zeros((nv, 4))
    for c in range(3):
        for _ in range(params["modes"]):
            k = rng.integers(1, params["max_wavenumber"] + 1, size=3)
            phase = rng.uniform(0.0, 2.0 * np.pi, size=3)
            field[:, c] += rng.normal() * np.prod(
                np.sin(np.pi * k * xi + phase), axis=1)
    field = field.reshape(-1)
    mask = free.copy()
    mask[3::4] = False
    field[~mask] = 0.0
    rms = math.sqrt(float(np.mean(field[mask] ** 2)))
    return field * (params["amplitude"] / rms)


@dataclasses.dataclass
class Window:
    """What the measured window did."""

    seconds: float = 0.0             # wall time of the whole window
    step_seconds: list = dataclasses.field(default_factory=list)
    segments: int = 0
    newton: int = 0
    gmres: int = 0
    unconverged: int = 0
    nonfinite: int = 0
    # (segment, step, u_old, u_new) on the host, one drawn per segment
    kept: list = dataclasses.field(default_factory=list)
    traced_steps: int = 0
    traced_seconds: float = 0.0      # wall time of the profiled segments

    @property
    def steps(self) -> int:
        return len(self.step_seconds)


def run_segment(system, start: torch.Tensor, n_steps: int, *,
                window: Window | None = None, keep=(),
                segment: int = 0) -> list:
    """n_steps steps from `start`; each step's host time ends in a device
    sync, and the answers of the steps in `keep` go to the window's host
    copies.  Returns the flags of non-finite states (device tensors)."""
    u = u_old = start
    du = torch.zeros_like(start)
    flags = []
    for j in range(n_steps):
        t0 = time.perf_counter()
        res = system.step(u, u_old, du)
        system.sync()
        t1 = time.perf_counter()
        flags.append(~torch.isfinite(res.u).all())
        if window is not None:
            window.step_seconds.append(t1 - t0)
            window.newton += res.newton
            window.gmres += res.gmres
            window.unconverged += not res.converged
            if j in keep:
                window.kept.append((segment, j, u_old.cpu(), res.u.cpu()))
        u = u_old = res.u
        du = res.delta_u
    return flags


def lead_in(system, start: torch.Tensor, n_steps: int) -> torch.Tensor:
    """The state after n_steps steps from `start` (set-up's lead-in)."""
    u = u_old = start
    du = torch.zeros_like(start)
    for _ in range(n_steps):
        res = system.step(u, u_old, du)
        u = u_old = res.u
        du = res.delta_u
    return u


def replay(system, start: torch.Tensor, params: dict, seconds: float,
           seed: int, traced=None) -> Window:
    """The measured window: whole segments until `seconds` have passed.
    `traced(segment_index)` gives a context manager that profiles that
    segment, or None."""
    rng = seeded_rng(seed, "checks")
    n = params["segment_steps"]
    w = Window()
    flags = []
    t0 = time.perf_counter()
    while True:
        ctx = traced(w.segments) if traced is not None else None
        keep = (int(rng.integers(n)),)
        if ctx is None:
            flags += run_segment(system, start, n, window=w, keep=keep,
                                 segment=w.segments)
        else:
            t = time.perf_counter()
            with ctx:
                flags += run_segment(system, start, n, window=w, keep=keep,
                                     segment=w.segments)
            w.traced_seconds += time.perf_counter() - t
            w.traced_steps += n
        w.segments += 1
        if time.perf_counter() - t0 >= seconds:
            break
    w.seconds = time.perf_counter() - t0
    w.nonfinite = int(torch.stack(flags).sum()) if flags else 0
    return w


def checked(window: Window, params: dict, seed: int) -> list:
    """The kept answers the comparison reads: all of them, or
    `max_checks` drawn from the seed, the last segment's always among
    them."""
    kept = window.kept
    limit = params["max_checks"]
    if len(kept) <= limit:
        return kept
    rng = seeded_rng(seed, "sample")
    pick = rng.choice(len(kept) - 1, size=limit - 1, replace=False)
    return [kept[i] for i in sorted(pick)] + [kept[-1]]
