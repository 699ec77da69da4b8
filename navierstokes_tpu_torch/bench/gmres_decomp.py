"""Per-iteration decomposition of the preconditioned GMRES: the port's
counterpart of the JAX package's `bench/gmres_decomp.py`.

Times the real solver components, every entry of the `parts` that
`_prep_operators` returns (never re-implementations of them), and the
preconditioned matvec, with `chained_op_time` (CUDA events on the card);
then the CGS2 projection against the live rows 0..k of a (restart+1, n)
basis at k = restart // 2 (the four GEMVs of cgs2='xla', and the fused
projection K3 under `--cgs2 pallas|pallas_comp`); then the end-to-end
slope of `_solve_prepared` between maxiter 32 and 64 (GMRES ends a
restart cycle, so the slope divides by the iterations it did).

'sch' parts: apply_A (4x4), apply_F (3x3), apply_S (S_hat), fhat, shat,
minv; 'tlp' and 'tl' parts: apply_A, apply_Dinv, coarse, minv.

Usage:
    python -m navierstokes_tpu_torch.bench.gmres_decomp --matrix-id 8 \
        [--preconditioner two_level|auto|schur] [--spmv plane|auto] \
        [--coarse-agg 128] [--cgs2 pallas] [--skip-slope] [--device cuda] \
        [--disc-cache DIR]

The defaults are the JAX tool's configuration: preconditioner
'two_level', `SolverConfig`'s own spmv (the scalar-DIA 'tl' prep), and
coarse_agg from the tool's table (48 at matrix 6, 128 at 8, 256 at 10,
else 48).  The port's opt-ins: `--preconditioner auto` (the f32 product
default: 'tlp' up to 150k rows, 'sch' above) and `--preconditioner
schur`, both on the plane layout unless `--spmv` says otherwise and with
coarse_agg from the solver's size schedule, as `run.py` has it, and
`--spmv`.  `--disc-cache DIR` loads the discretization from DIR, or
builds it and saves it there.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from navierstokes_tpu_torch.bench.timing import chained_op_time
from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu_torch.fem.assembly import cached_discretization
from navierstokes_tpu_torch.mesh.box import scaling_series_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.ops.cgs2 import cgs2_project

# The JAX tool's per-size coarse_agg (benchlogs/transient_scaling.txt);
# other matrices take 48.
COARSE_AGG = {6: 48, 8: 128, 10: 256}
COARSE_AGG_DEFAULT = 48

# Components per plane of the 'sch' parts that act on a velocity (3) or a
# pressure (1) vector; every other part takes the whole vector.
_SCHUR_COMPONENTS = {"apply_F": 3, "fhat": 3, "apply_S": 1, "shat": 1}


def log(*args):
    print(*args, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _part_length(solver, prep, name: str) -> int:
    """Length of the vectors part `name` of `prep` takes."""
    if prep.kind == "sch":
        return _SCHUR_COMPONENTS.get(name, 4) * prep.nbp
    if prep.kind == "tlp":
        return 4 * prep.nbp
    return solver.disc.ndof


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--matrix-id", type=int, default=6)
    p.add_argument("--preconditioner", default="two_level",
                   choices=["two_level", "auto", "schur"])
    p.add_argument("--spmv", default=None,
                   choices=["plane", "auto", "pallas", "xla"],
                   help="override SolverConfig.spmv (default: its own "
                        "under two_level, 'plane' under auto and schur)")
    p.add_argument("--coarse-agg", type=int, default=None,
                   help="default: under two_level the JAX tool's table by "
                        "matrix, else the solver's size schedule")
    p.add_argument("--restart", type=int, default=30)
    p.add_argument("--cgs2", default="xla",
                   choices=["xla", "pallas", "pallas_comp"],
                   help="also time the fused projection K3, and route the "
                        "end-to-end slope through it")
    p.add_argument("--skip-slope", action="store_true",
                   help="components only")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--disc-cache", default=None,
                   help="directory to load the discretization from, or to "
                        "save it to when it holds none")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        p.error("--device cuda but no CUDA device is available "
                "(pass --device cpu to run on the CPU)")
    return args


def ns_config(args: argparse.Namespace) -> NSConfig:
    """The configuration the tool times.  Under two_level, the JAX tool's:
    SolverConfig's own spmv and coarse_agg from its table; under auto and
    schur, the port's product default on the plane layout, coarse_agg left
    to the solver's size schedule (`resolve_coarse_defaults`)."""
    two_level = args.preconditioner == "two_level"
    agg = args.coarse_agg
    if agg is None and two_level:
        agg = COARSE_AGG.get(args.matrix_id, COARSE_AGG_DEFAULT)
    spmv = args.spmv or (None if two_level else "plane")
    krylov = SolverConfig(rtol=1e-5, atol=1e-6, maxiter=1000,
                          neumann_order=0,
                          preconditioner=args.preconditioner,
                          coarse_agg=agg, coarse_dense_max=16384,
                          restart=args.restart, cgs2=args.cgs2,
                          **({"spmv": spmv} if spmv else {}))
    return NSConfig(dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
                    newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                                        du_tol=float("inf")),
                    krylov=krylov, stokes_krylov=krylov)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    cfg = ns_config(args)
    disc = None
    if args.disc_cache:
        t0 = time.perf_counter()
        disc, loaded = cached_discretization(
            args.disc_cache, lambda: scaling_series_mesh(args.matrix_id),
            torch.float32, device)
        _sync(device)
        log(f"disc cache {'loaded' if loaded else 'built and saved'} in "
            f"{time.perf_counter() - t0:.3f} s")
        mesh = disc.mesh
    else:
        mesh = scaling_series_mesh(args.matrix_id)

    t0 = time.perf_counter()
    solver = NavierStokesSolver(mesh, cfg, disc=disc, device=device)
    solver.release_assembly_buffers()
    _sync(device)
    prep = solver._exact_prep
    n = solver.disc.ndof
    cs = solver._coarse_space
    kr = solver.cfg.krylov
    log(f"ndof={n} prep={prep.kind} preconditioner={kr.preconditioner} "
        f"coarse_agg={kr.coarse_agg} n_agg={cs.n_agg} "
        f"prep {time.perf_counter() - t0:.3f} s")
    if prep.kind == "sch":
        log(f"S_hat: {len(prep.s_offsets)} node offsets "
            f"{prep.s_offsets[0]}..{prep.s_offsets[-1]}; cheby_v "
            f"{prep.cheby_v}, cheby_s {prep.cheby_s}, shape {prep.shape}")
        log("host prep (s): " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in prep.seconds.items()))
    matvec, _, parts = solver._prep_operators(prep)
    n_vec = _part_length(solver, prep, "apply_A")
    rng = np.random.default_rng(0)
    dtype = solver.dtype

    def vector(length: int) -> torch.Tensor:
        return torch.as_tensor(rng.standard_normal(length), dtype=dtype,
                               device=device)

    rows = {}

    def timed(label, fn, x0, operands=()):
        t = chained_op_time(fn, x0, operands=operands)
        rows[label] = t
        log(f"  {label:44s} {t * 1e6:10.2f} us")

    log("components (chained slope, the solver's own closures):")
    for name, fn in parts.items():
        timed(name, fn, vector(_part_length(solver, prep, name)))
    timed("matvec = minv(A x)", matvec, vector(n_vec))

    m = args.restart
    k = m // 2
    V = torch.as_tensor(rng.standard_normal((m + 1, n_vec)), dtype=dtype,
                        device=device)

    def gemvs(w, Vb):
        Vk = Vb[:k + 1]
        h1 = Vk @ w
        w = w - Vk.T @ h1
        h2 = Vk @ w
        return w - Vk.T @ h2

    cgs2_key = f"CGS2, four GEMVs on V[:{k + 1}]"
    timed(cgs2_key, gemvs, vector(n_vec), operands=(V,))
    if args.cgs2 != "xla":
        comp = args.cgs2 == "pallas_comp"
        cgs2_key = f"CGS2, fused projection K3 ({args.cgs2}, k={k})"
        timed(cgs2_key,
              lambda w, Vb: cgs2_project(Vb, w, k, compensated=comp)[0],
              vector(n_vec), operands=(V,))
    del V
    est = rows["matvec = minv(A x)"] + rows[cgs2_key]
    rows["estimate"] = est
    log(f"  matvec + CGS2 estimate per iteration: {est * 1e6:10.2f} us")
    if args.skip_slope:
        return rows

    b0 = vector(n)

    def timed_solve(iters: int, reps: int = 5) -> tuple:
        # each solve's right-hand side is the previous normalized solution
        kv = dataclasses.replace(kr, rtol=0.0, atol=0.0, maxiter=iters)

        def solve(v):
            res = solver._solve_prepared(prep, v, kv)
            return res.x / torch.clamp(res.x.abs().max(), min=1e-30), \
                res.iters

        v, done = solve(b0)                     # warm-up
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            v, done = solve(v)
        _sync(device)
        return (time.perf_counter() - t0) / reps, done

    log("end-to-end (_solve_prepared, fixed iteration counts):")
    t32, i32 = timed_solve(32)
    log(f"  gmres 32 fixed iters ({i32} done) {t32 * 1e3:10.3f} ms")
    t64, i64 = timed_solve(64)
    log(f"  gmres 64 fixed iters ({i64} done) {t64 * 1e3:10.3f} ms")
    per = (t64 - t32) / max(i64 - i32, 1)
    rows.update({"gmres_32": t32, "gmres_64": t64, "per_iteration": per})
    log(f"  per-iteration (slope {i32}->{i64} iterations) "
        f"{per * 1e6:10.2f} us (matvec + "
        f"CGS2 predict {est * 1e6:.2f}; the gap is the V update, the "
        "Givens rotations, the norms and the host)")
    return rows


if __name__ == "__main__":
    main()
