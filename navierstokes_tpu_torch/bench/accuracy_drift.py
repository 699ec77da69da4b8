"""Long-horizon f32-against-f64 drift curve: the JAX package's
`bench/accuracy_drift.py`, with the same configs, checkpoints and lines.

The reference's headline artifact is a 1000-step double-precision corpus;
the flagship runs float32.  This runs the f32 flagship config ('tlp',
two-level on the component-plane layout: K1 on the card) and the f64
reference-grade config (the CLI's f64 default, block-Jacobi with Neumann
2: K2 in float64) side by side from each one's own Stokes state, and
prints the relative L2 drift between the two trajectories at log-spaced
checkpoints.  Both legs run on `--device` (the card by default: the H100
runs float64 natively).  The f64 Stokes solve at rtol 1e-12 stops at its
iteration limit at matrices 4 and 6, in the JAX package too; the drift is
measured between the two legs' own trajectories all the same.

Usage:
    python -m navierstokes_tpu_torch.bench.accuracy_drift --matrix-id 3 \
        [--steps 100] [--dt 1e-3] [--device cuda]

One line per checkpoint:
    DRIFT id=3 step=20 t=0.020 rel_l2=1.23e-04 newton32=2 lin32=40 ...
and a summary:
    DRIFT_SUMMARY id=3 steps=100 first=... last=... max=... growth...
"""

from __future__ import annotations

import argparse
import bisect
import sys
from typing import NamedTuple

import numpy as np
import torch

from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu_torch.mesh.box import scaling_series_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver


class Drift(NamedTuple):
    rows: list                   # (step, rel_l2) at each checkpoint
    u32: torch.Tensor            # the f32 leg's last state
    u64: torch.Tensor            # the f64 leg's last state


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _checkpoints(n: int) -> list:
    pts = sorted({1, 2, 3, 5, 7, 10, 15, 20, 30, 50, 70, 100, 150, 200,
                  300, 500, 700, 1000} | {n})
    return [p for p in pts if p <= n]


def drift_configs(steps: int, dt: float) -> tuple:
    """(cfg32, cfg64): the CLI's f32 flagship defaults (two_level, plane,
    auto aggregate schedule) and its f64 defaults (reference-grade
    tolerances), as the JAX tool sets them."""
    kr32 = SolverConfig(rtol=1e-5, atol=1e-6, maxiter=1000,
                        neumann_order=0, preconditioner="two_level",
                        spmv="plane")
    cfg32 = NSConfig(
        dt=dt, t_final=steps * dt, reynolds=300.0, delta=0.05,
        dtype="float32",
        newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                            du_tol=float("inf")),
        krylov=kr32, stokes_krylov=kr32)
    cfg64 = NSConfig(
        dt=dt, t_final=steps * dt, reynolds=300.0, delta=0.05,
        dtype="float64", newton=NewtonConfig(), krylov=SolverConfig(),
        stokes_krylov=SolverConfig(rtol=1e-12, atol=1e-12, maxiter=2000))
    return cfg32, cfg64


def run_drift(matrix_id: int, steps: int, dt: float,
              device="cuda") -> Drift:
    """Run both legs `steps` steps; print the DRIFT lines and the summary."""
    mesh = scaling_series_mesh(matrix_id)
    cfg32, cfg64 = drift_configs(steps, dt)
    s32 = NavierStokesSolver(mesh, cfg32, device=device)
    s64 = NavierStokesSolver(mesh, cfg64, device=device)
    log(f"mesh: {mesh.nv} nodes ({mesh.ndof} rows), {mesh.ne} tets; "
        f"device {s32.device}, preps {s32.prep_kind} / {s64.prep_kind}")

    u32, u64 = s32.stokes_init(), s64.stokes_init()
    d32, d64 = torch.zeros_like(u32), torch.zeros_like(u64)
    uo32, uo64 = u32, u64
    marks = set(_checkpoints(steps))
    rows = []
    for k in range(1, steps + 1):
        u32n, d32, st32 = s32.step(u32, uo32, d32)
        u64n, d64, st64 = s64.step(u64, uo64, d64)
        uo32, uo64 = u32, u64
        u32, u64 = u32n, u64n
        if k in marks:
            a = u32.double().cpu().numpy()
            b = u64.cpu().numpy()
            rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            rows.append((k, rel))
            print(f"DRIFT id={matrix_id} step={k} t={k * dt:.3f} "
                  f"rel_l2={rel:.3e} newton32={int(st32.iters)} "
                  f"lin32={int(st32.lin_iters)} "
                  f"newton64={int(st64.iters)}", flush=True)
            if not np.isfinite(rel):
                break

    ks = [r[0] for r in rows]
    vals = [r[1] for r in rows]
    # growth over the last decade of steps: drift(end) / drift(end / 10);
    # ~1 is saturated, >> 1 secular growth
    i10 = bisect.bisect_left(ks, max(ks[-1] // 10, 1))
    ratio = vals[-1] / vals[i10] if vals[i10] > 0 else float("inf")
    print(f"DRIFT_SUMMARY id={matrix_id} steps={ks[-1]} first={vals[0]:.3e} "
          f"last={vals[-1]:.3e} max={max(vals):.3e} "
          f"growth_last_decade={ratio:.2f}x", flush=True)
    return Drift(rows, u32, u64)


def main(argv=None) -> Drift:
    p = argparse.ArgumentParser(description="f32-vs-f64 drift curve "
                                            "(PyTorch port)")
    p.add_argument("--matrix-id", type=int, required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--device", default="cuda",
                   help="torch device of both legs: cuda (default) or cpu")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        p.error("--device cuda but no CUDA device is available "
                "(pass --device cpu to run on the CPU)")
    return run_drift(args.matrix_id, args.steps, args.dt, args.device)


if __name__ == "__main__":
    main()
