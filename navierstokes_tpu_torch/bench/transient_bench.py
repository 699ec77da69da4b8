"""End-to-end transient step benchmark over the scaling-series meshes: the
port's counterpart of the JAX package's `bench/transient_bench.py`.

Per-step wall time of the Newton step with the f32 CLI settings (or any
knob overridden on the command line), with the setup phases timed apart.

Usage:
    python -m navierstokes_tpu_torch.bench.transient_bench --matrix-id 8 \
        [--steps 5] [--preconditioner auto] [--coarse-agg 128] \
        [--schur-v-cheby 2] [--restart 30] [--device cuda]

Prints one summary line per run:
    TRANSIENT id=8 ndof=511024 setup_s=... stokes_s=... compile_s=... \
        step_ms=... newton=N lin=M mean_lin=... cfg=...

The base config is the JAX tool's: two_level on the plane layout, so that
its 'defaults' lines stay comparable; `--preconditioner auto` gives the
product default (the Schur tier above 150k rows).  `setup_s` is the solver
and its operator preparation, `stokes_s` the Stokes solve, `compile_s` the
first step plus every nvcc build of the run (the JAX tool's first step
carried the XLA compile), and `step_ms` the mean of the later steps, each
ending in `torch.cuda.synchronize()`.  `--sweep` runs several override
sets on one discretization.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu_torch.fem.assembly import build_discretization
from navierstokes_tpu_torch.mesh.box import scaling_series_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.ops import cuda_lib

# flags that override the SolverConfig field of the same name
_OVERRIDES = ("preconditioner", "coarse_agg", "coarse_ml_smooth",
              "coarse_ml_cycles", "coarse_ml_damp", "coarse_dense_max",
              "coarse_smooth_omega", "coarse_basis", "coarse_cheby",
              "coarse_cheby_fraction", "schur_cheby", "schur_v_cheby",
              "schur_shape", "deflation_k", "deflation_arnoldi", "restart",
              "spmv", "neumann_order", "cgs2", "method")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def base_krylov() -> SolverConfig:
    """The JAX tool's base: the historical two_level flagship on the plane
    layout, f32 tolerances."""
    return SolverConfig(rtol=1e-5, atol=1e-6, maxiter=1000, neumann_order=0,
                        preconditioner="two_level", spmv="plane")


def run_one(matrix_id: int, steps: int, overrides: dict, device,
            mesh=None, disc=None, release: bool = False,
            skip_stokes: bool = False) -> dict:
    device = torch.device(device)
    base = base_krylov()
    krylov = dataclasses.replace(base, **overrides)
    # The Stokes solve keeps the base tolerances and method; the operator it
    # solves with is prepared from cfg.krylov, as in the JAX package.
    cfg = NSConfig(dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
                   newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                                       du_tol=float("inf")),
                   krylov=krylov, stokes_krylov=base)
    if mesh is None:
        mesh = scaling_series_mesh(matrix_id)
    nvcc0 = cuda_lib.nvcc_seconds()
    t0 = time.perf_counter()
    solver = NavierStokesSolver(mesh, cfg, disc=disc, device=device)
    solver._ensure_prepared()
    _sync(device)
    setup_s = time.perf_counter() - t0
    log(f"id={matrix_id} ndof={solver.disc.ndof} prep={solver.prep_kind} "
        f"setup {setup_s:.3f} s")

    t0 = time.perf_counter()
    if skip_stokes:
        u = torch.zeros(solver.disc.ndof, dtype=solver.dtype, device=device)
        stokes_s = 0.0
        log("stokes skipped (zero init)")
    else:
        u = solver.stokes_init()
        _sync(device)
        stokes_s = time.perf_counter() - t0
        log(f"stokes init {stokes_s:.3f} s, "
            f"{solver.stokes_result.iters} GMRES")
    if release:
        solver.release_assembly_buffers()
        log("assembly buffers released")

    nvcc_before_step = cuda_lib.nvcc_seconds() - nvcc0
    t0 = time.perf_counter()
    u1, du1, stats = solver.step(u, u, torch.zeros_like(u))
    _sync(device)
    compile_s = time.perf_counter() - t0 + nvcc_before_step
    log(f"step 1 (with every nvcc build of the run) {compile_s:.3f} s "
        f"newton={stats.iters} lin={stats.lin_iters}")

    # Backward Euler: the previous time solution is both the Newton initial
    # guess and u_old, as model.run() does.
    u_cur, du_cur = u1, du1
    per_step = []
    t_all = 0.0
    for _ in range(steps):
        t0 = time.perf_counter()
        u_cur, du_cur, stats = solver.step(u_cur, u_cur, du_cur)
        _sync(device)
        t_all += time.perf_counter() - t0
        per_step.append(stats)
    step_ms = t_all / max(steps, 1) * 1e3
    if not bool(torch.isfinite(u_cur).all()):
        raise AssertionError("non-finite state")
    counts = [(s.iters, s.lin_iters) for s in per_step]
    mean_lin = sum(lin for _, lin in counts) / max(len(counts), 1)
    log("per-step (newton, lin): " + " ".join(map(str, counts))
        + f"; mean lin {mean_lin:.1f}"
        + (f"; ms/lin-iter {step_ms / mean_lin:.3f}" if mean_lin else ""))
    result = {
        "id": matrix_id, "ndof": solver.disc.ndof, "setup_s": setup_s,
        "stokes_s": stokes_s, "compile_s": compile_s, "step_ms": step_ms,
        "newton": stats.iters, "lin": stats.lin_iters, "mean_lin": mean_lin,
    }
    cfg_str = ",".join(f"{k}={v}" for k, v in sorted(overrides.items())) \
        or "defaults"
    print("TRANSIENT "
          + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in result.items())
          + f" prep={solver.prep_kind} cfg={cfg_str}", flush=True)
    return result


def _parse_val(s: str):
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--matrix-id", type=int, required=True)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--preconditioner", default=None)
    p.add_argument("--coarse-agg", type=int, default=None)
    p.add_argument("--coarse-ml-smooth", type=int, default=None)
    p.add_argument("--coarse-ml-cycles", type=int, default=None)
    p.add_argument("--coarse-ml-damp", type=float, default=None)
    p.add_argument("--coarse-dense-max", type=int, default=None)
    p.add_argument("--coarse-smooth-omega", type=float, default=None)
    p.add_argument("--coarse-basis", default=None,
                   choices=["const", "linear"])
    p.add_argument("--coarse-cheby", type=int, default=None)
    p.add_argument("--coarse-cheby-fraction", type=float, default=None)
    p.add_argument("--schur-cheby", type=int, default=None)
    p.add_argument("--schur-v-cheby", type=int, default=None)
    p.add_argument("--schur-shape", default=None, choices=["lower", "full"])
    p.add_argument("--restart", type=int, default=None)
    p.add_argument("--spmv", default=None,
                   choices=["auto", "xla", "pallas", "plane"])
    p.add_argument("--neumann-order", type=int, default=None)
    p.add_argument("--cgs2", default=None,
                   choices=["xla", "pallas", "pallas_comp"])
    p.add_argument("--deflation-k", type=int, default=None)
    p.add_argument("--deflation-arnoldi", type=int, default=None)
    p.add_argument("--method", default=None,
                   choices=["gmres", "ca_gmres", "cg"])
    p.add_argument("--release", action="store_true",
                   help="free the assembly buffers after Stokes "
                        "(incompatible with --sweep, which reuses the "
                        "discretization)")
    p.add_argument("--skip-stokes", action="store_true",
                   help="zero initial condition (probing large meshes)")
    p.add_argument("--disc-cache", default=None,
                   help="(not ported: ROADMAP slice 8)")
    p.add_argument("--sweep", default=None,
                   help="semicolon-separated override sets, each "
                        "'key=val,key=val' (SolverConfig field names); all "
                        "runs share one discretization")
    args = p.parse_args(argv)
    if args.disc_cache:
        raise NotImplementedError(
            "--disc-cache is not ported to navierstokes_tpu_torch yet "
            "(ROADMAP slice 8: bench tools, the discretization cache)")
    if args.release and args.sweep is not None:
        p.error("--release frees the discretization that --sweep shares")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda but no CUDA device is available "
                "(pass --device cpu to run on the CPU)")
    overrides = {k: getattr(args, k) for k in _OVERRIDES
                 if getattr(args, k) is not None}

    if args.sweep is None:
        return [run_one(args.matrix_id, args.steps, overrides, device,
                        release=args.release, skip_stokes=args.skip_stokes)]

    mesh = scaling_series_mesh(args.matrix_id)
    t0 = time.perf_counter()
    disc = build_discretization(mesh, torch.float32, device)
    log(f"shared discretization built in {time.perf_counter() - t0:.3f} s")
    results = []
    for chunk in args.sweep.split(";"):
        ov = dict(overrides)
        for kv in filter(None, (c.strip() for c in chunk.split(","))):
            k, v = kv.split("=")
            ov[k.strip()] = _parse_val(v.strip())
        try:
            results.append(run_one(args.matrix_id, args.steps, ov, device,
                                   mesh=mesh, disc=disc,
                                   skip_stokes=args.skip_stokes))
        except Exception as e:      # record and go on with the sweep
            print(f"TRANSIENT id={args.matrix_id} FAILED cfg={chunk}: "
                  f"{e!r}", flush=True)
    return results


if __name__ == "__main__":
    main()
