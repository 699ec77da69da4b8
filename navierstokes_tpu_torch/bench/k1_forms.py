"""Kernel K1's forms on the card, timed so that two versions compare in
turns.

    python navierstokes_tpu_torch/bench/k1_forms.py [--root DIR] [--reps N]

K1 is imported from the `navierstokes_tpu_torch` package under `--root`
(default: the checkout this file is in), so that an unpacked older commit
(`git archive <commit> | tar -x -C DIR`) is timed by the same code; run
the two alternately (old, new, new, old) on one card and compare their
lines.  Each form is an operator of the shape a solver path gives K1,
with random values made on the card from a fixed seed (a banded SpMV does
the same work whatever its values): the matrix-6 masked forms, S_hat on
its 65 node offsets and the Schur tier's sub-blocks at matrices 8-10
(nbp = `plane_nbp` of the mesh's nodes), the ghost-row form on one
interior shard of matrix 6 in 4 and 8 shards, and a launch's floor (1x1
on 128 rows, one offset).  Each form runs on the
route the wrapper chooses and prints, as one JSON line: CUDA-event ms
(median of `--reps`) flushed (a 256 MB buffer rewritten first), flushed
with the L2 left clean, and L2-warm; the host us per launch (the median
of 4 loops of 1,000 launches with no sync, in turns with as many on the
'rows' route, whose launch encodes nothing); the bound (bytes over 3.35
TB/s); and a hash of the output, equal between two versions where they
agree bit for bit.  With `--distributed` it also runs the path the
ghost-row form serves (matrix 6 over 4 shards of the card, Stokes + 3
steps) and adds its Newton and GMRES counts, K1's ghost-row launches and
a hash of the state.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)


def event_ms(torch, fn, reps: int, flush=None, clean: bool = False):
    """Median device time of fn() in ms over `reps` runs (CUDA events; the
    stream sleeps first so that the events bracket device work only)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
            if clean:
                flush.sum()
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def forms(box, np) -> list:
    """(name, node offsets, n_out, n_in, nb, dtype name, shards or 0):
    every K1 form of PERF.md's kernel table.  `box` is the package's
    mesh/box.py: the offsets come from a slab one cell long, the nodes are
    (nx + 1)(ny + 1)(nz + 1) of the series' cells."""
    def offsets(m):
        _, tets = box.box_mesh(1, *box.SCALING_SERIES_DIMS[m][1:])
        return tuple(int(d) for d in np.unique(tets[:, :, None]
                                               - tets[:, None]))

    def nodes(m):
        nx, ny, nz = box.SCALING_SERIES_DIMS[m]
        return (nx + 1) * (ny + 1) * (nz + 1)

    # a launch's floor on the tiled route: 1x1 on 128 rows, one offset
    out = [("floor: 1x1, 128 rows, one offset", (0,), 1, 1, 128, "float32",
            0)]
    for m in (6, 8, 9, 10):
        o = offsets(m)
        s_hat = tuple(sorted({a + b for a in o for b in o}))
        nb = nodes(m)
        if m == 6:
            for shape, dt in (("4x4", "float32"), ("4x4", "float64"),
                              ("3x3", "float32"), ("1x1", "float32")):
                out.append((f"m6 {shape} {dt}", o, int(shape[0]),
                            int(shape[2]), nb, dt, 0))
            for P, shape, dt in ((4, "4x4", "float32"), (4, "4x4", "float64"),
                                 (4, "3x3", "float32"), (8, "4x4", "float32")):
                out.append((f"m6 {shape} {dt} shard of {P}", o,
                            int(shape[0]), int(shape[2]), nb, dt, P))
        for dt in (("float32", "float64") if m in (6, 8) else ("float32",)):
            out.append((f"m{m} S_hat {dt}", s_hat, 1, 1, nb, dt, 0))
        if m >= 8:
            for shape in ("4x4", "3x3", "1x3", "3x1")[:4 if m == 8 else 3]:
                out.append((f"m{m} {shape} float32", o, int(shape[0]),
                            int(shape[2]), nb, "float32", 0))
    return out


def distributed_path(torch, dev) -> dict:
    """The path the ghost-row form serves: matrix 6 at the CLI's float32
    defaults (run.py) over 4 shards of one card, Stokes + 3 steps; its
    counts and a hash of the state, equal between two versions that agree
    bit for bit."""
    import dataclasses
    import warnings

    from navierstokes_tpu_torch import run
    from navierstokes_tpu_torch.config import NewtonConfig, NSConfig
    from navierstokes_tpu_torch.mesh.box import scaling_series_mesh
    from navierstokes_tpu_torch.ops import plane_dia as pd
    from navierstokes_tpu_torch.parallel import DistributedNavierStokesSolver

    kr = run.default_f32_krylov()
    cfg = NSConfig(dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
                   newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                                       du_tol=float("inf")),
                   krylov=kr, stokes_krylov=dataclasses.replace(kr))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        solver, _ = DistributedNavierStokesSolver.from_mesh(
            scaling_series_mesh(6), cfg, devices=[dev] * 4)
        pd.reset_counters()
        t0 = time.perf_counter()
        u = solver.run(3, monitor=False)
        torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0,
            "stokes_gmres": solver.stokes_result.iters,
            "newton": [s.iters for _, s, _ in solver.history],
            "gmres": [s.lin_iters for _, s, _ in solver.history],
            "step_ms": [1e3 * sec for _, _, sec in solver.history],
            "k1_halo_launches": pd.halo_launches,
            "state_sha": hashlib.sha256(
                u.cpu().numpy().tobytes()).hexdigest()[:16]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--only", default="", help="forms whose name holds this")
    ap.add_argument("--distributed", action="store_true",
                    help="also run the distributed path (matrix 6, 4 "
                    "shards, Stokes + 3 steps)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from navierstokes_tpu_torch.mesh import box
    from navierstokes_tpu_torch.ops import plane_dia as pd
    from navierstokes_tpu_torch.parallel import partitioned as tpart

    if not torch.cuda.is_available():
        raise SystemExit("k1_forms: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    result = {"root": os.path.abspath(args.root), "card": card, "forms": {}}
    for name, offs, n_out, n_in, nb, dt, P in forms(box, np):
        if args.only not in name:
            continue
        dtype = getattr(torch, dt)
        size = torch.tensor([], dtype=dtype).element_size()
        gen = torch.Generator(device=dev).manual_seed(
            int(hashlib.sha256(name.encode()).hexdigest()[:8], 16))
        halo = 0
        if P:
            Lb = tpart.plane_shard_nodes(nb, offs, P, 48, size)
            halo = pd.ghost_width(offs, size)
            nbp, n_live = Lb, Lb
            x = torch.randn(n_in * (Lb + 2 * halo), generator=gen,
                            dtype=dtype, device=dev)
        else:
            nbp, n_live = pd.plane_nbp(nb), nb
            x = torch.randn(n_in * nbp, generator=gen, dtype=dtype,
                            device=dev)
        data = torch.randn((n_out, n_in * len(offs), nbp), generator=gen,
                           dtype=dtype, device=dev)

        def run(route=None):
            return pd.spmv_planes_cuda(offs, data, x, n_in=n_in, nb=n_live,
                                       halo=halo, route=route)

        route = pd.plane_route(offs, data, x, n_in, halo=halo)
        y = run()
        torch.cuda.synchronize()
        sha = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
        t = {key: event_ms(torch, run, args.reps, flush=fl, clean=cl)
             for key, fl, cl in (("flushed", flush, False),
                                 ("clean", flush, True),
                                 ("warm", None, False))}
        # host us per launch, the chosen route and 'rows' (which encodes
        # nothing) in turns: rows, chosen, chosen, rows, ...
        host = {"rows": [], route: []}
        for turn in ("rows", route, route, "rows") * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                run(turn)
            host[turn].append((time.perf_counter() - t0) / 1000 * 1e6)
        torch.cuda.synchronize()
        host_us = statistics.median(host[route])
        host_rows_us = statistics.median(host["rows"])
        plan = pd.tile_plan(offs, n_out, n_in, nbp, size, halo=halo)
        nbytes = size * (data.numel() + x.numel() + y.numel())
        result["forms"][name] = {
            "route": route, "nbp": nbp, "halo": halo,
            "plan": None if plan is None else pd.plan_text(plan),
            "ms_flushed": t["flushed"], "ms_clean": t["clean"],
            "ms_warm": t["warm"], "host_us": host_us,
            "host_rows_us": host_rows_us,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "y_sha": sha}
        print(f"{name}: {route}, {t['flushed']:.4f} / {t['clean']:.4f} / "
              f"{t['warm']:.4f} ms, host {host_us:.1f} us (rows "
              f"{host_rows_us:.1f})", flush=True)
        del data, x, y
    if args.distributed:
        result["distributed"] = distributed_path(torch, dev)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
