"""The two readings that each limit of `benchmark/check.py` is set from,
for one cell, in one process.

    python -m benchmark.control --workload m6_f32.early \
        --seeds 11,12,...,22 --segments 2

Set-up is the cell's own (mesh, solver, preparation, Stokes); then, for
each seed, the seeded start state and `--segments` segments of the cell's
traffic, every step's answer kept.  For each seed it prints one JSON line
with the three numbers read from

  program   the answers as the program produced them (the lower reading);
  control   the same answers at the precision next below the
            configuration's (the upper reading; `check.round_below`:
            TF32 for float32 with TF32 off, float32 for float64);
  unchanged a step that returns its state unchanged (u_new = u_old);
  altered   each answer with one free velocity DoF moved by 0.1;

and a last line with the largest program reading and the smallest of each
other kind over the seeds.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import check, traffic
from benchmark.reference.mesh import mesh_from_config
from benchmark.reference.problem import Reference, dirichlet
from benchmark.spec import Spec

KINDS = ("program", "control", "unchanged", "altered")


def altered(state: torch.Tensor, free: np.ndarray) -> torch.Tensor:
    """The state with its first free velocity DoF past the middle moved."""
    out = state.clone()
    idx = np.flatnonzero(free & (np.arange(free.size) % 4 != 3))
    out[idx[idx.size // 2]] += 0.1
    return out


def read_seeds(spec: Spec, name: str, seeds: list, segments: int,
               device: torch.device, amplitudes=(None,)) -> list:
    """One dict of readings per seed and perturbation amplitude (None: the
    cell's own; see the module's docstring)."""
    from benchmark.system import System

    cell = spec.cell(name)
    cfg = spec.config(cell["config"])
    coords, tets, tags = mesh_from_config(cfg["mesh"])
    is_bc, _ = dirichlet(coords, tags)
    system = System(cfg, coords, tets, tags, device)
    system.prepare()
    stokes = system.stokes()
    stokes_host = stokes.cpu()
    runs = []
    for amplitude, seed in [(a, s) for a in amplitudes for s in seeds]:
        params = dict(cell["perturbation"])
        if amplitude is not None:
            params["amplitude"] = amplitude
        pert = traffic.perturbation(coords, ~is_bc, params, seed)
        start = stokes + torch.as_tensor(pert).to(device, stokes.dtype)
        start = traffic.lead_in(system, start, cell["start_step"])
        w = traffic.Window()
        for s in range(segments):
            n = cell["segment_steps"]
            traffic.run_segment(system, start, n, window=w, keep=range(n),
                                segment=s)
        runs.append((seed, params["amplitude"], w))
    system.release()
    del system, stokes, start
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = Reference(coords, tets, tags, cfg, device)
    out = []
    for seed, amplitude, w in runs:
        pairs = [(old, new) for _, _, old, new in w.kept]
        row = {"seed": seed, "amplitude": amplitude, "steps": len(pairs),
               "newton_per_step": w.newton / w.steps,
               "gmres_per_step": w.gmres / w.steps,
               "unconverged": w.unconverged,
               "program": check.readings(reference, stokes_host, pairs),
               "control": check.readings(reference, stokes_host, pairs,
                                         control=cfg["dtype"]),
               "unchanged": check.readings(
                   reference, stokes_host, [(o, o) for o, _ in pairs]),
               "altered": check.readings(
                   reference, stokes_host,
                   [(o, altered(n, ~is_bc)) for o, n in pairs])}
        out.append(row)
    return out


def summary(rows: list) -> dict:
    """The largest program reading and the smallest of each other kind."""
    out = {}
    for kind in KINDS:
        pick = max if kind == "program" else min
        out[kind] = {n: pick(r[kind][n] for r in rows) for n in check.NAMES}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    p.add_argument("--segments", type=int, default=1)
    p.add_argument("--amplitudes", default=None,
                   help="comma-separated perturbation amplitudes to read "
                        "instead of the cell's own (the sweep that chose it)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    rows = read_seeds(Spec.load(), args.workload,
                      [int(s) for s in args.seeds.split(",")],
                      args.segments, device,
                      [float(a) for a in args.amplitudes.split(",")]
                      if args.amplitudes else (None,))
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
