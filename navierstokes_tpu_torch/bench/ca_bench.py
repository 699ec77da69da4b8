"""CA-GMRES against GMRES on one device: the JAX package's
`bench/ca_bench.py`, with the same two tables.

Does the s-step machinery (the intent of the reference's
`src/sstepgmres.c:126-149`) pay on one device, where no inter-device
latency is saved?  Both tables time the solver's own path
(`_solve_prepared`) on the prepared exact Jacobian of the f32 two-level
config the JAX tool sets (preconditioner 'two_level', spmv 'auto': the
scalar-DIA layout 'tl', K2 on the card):

- fixed iteration counts (32 and 64, rtol = atol = 0), timed by
  `bench/timing.chained_op_time`: the slope per iteration;
- a solve to tolerance of one fixed right-hand side, for GMRES(30) and
  CA-GMRES with the monomial and the Leja-ordered Newton basis at basis
  lengths 16, 12, 8 and 6: wall ms of the mean of 5 solves after one
  warm-up, iterations, residual and convergence.

Usage:
    python -m navierstokes_tpu_torch.bench.ca_bench [--matrix-id 6] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from navierstokes_tpu_torch.bench.timing import chained_op_time
from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu_torch.mesh.box import scaling_series_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver

# (method, restart, basis) of the tolerance sweep
SWEEP = [("gmres", 30, "monomial")] + [
    ("ca_gmres", m, basis)
    for basis in ("monomial", "newton") for m in (16, 12, 8, 6)]


def sweep_name(method: str, restart: int, basis: str) -> str:
    """The sweep row's key in `main`'s result: `basis:restart`
    (`gmres:30` for GMRES)."""
    return f"{'gmres' if method == 'gmres' else basis}:{restart}"


def log(*a):
    print(*a, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Print both tables; returns {"fixed": {method: (t32, t64, per)},
    "sweep": {name: (ms, iters, resnorm, converged)}} (seconds in
    "fixed")."""
    p = argparse.ArgumentParser(description="CA-GMRES against GMRES "
                                            "(PyTorch port)")
    p.add_argument("--matrix-id", type=int, default=6)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda but no CUDA device is available "
                "(pass --device cpu to run on the CPU)")

    krylov = SolverConfig(rtol=1e-5, atol=1e-6, maxiter=1000,
                          neumann_order=0, preconditioner="two_level",
                          coarse_agg=48)
    cfg = NSConfig(
        dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
        newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                            du_tol=float("inf")),
        krylov=krylov, stokes_krylov=krylov)
    solver = NavierStokesSolver(scaling_series_mesh(args.matrix_id), cfg,
                                device=device)
    solver._ensure_prepared()
    prep = solver._exact_prep
    n = solver.disc.ndof
    log(f"ndof={n} prep={solver.prep_kind} device={device}")
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                        dtype=torch.float32, device=device)

    def fixed(method, iters):
        kv = dataclasses.replace(krylov, method=method, rtol=0.0, atol=0.0,
                                 maxiter=iters)
        return lambda v: solver._solve_prepared(prep, v, kv).x

    out = {"fixed": {}, "sweep": {}}
    for method in ("gmres", "ca_gmres"):
        t32 = chained_op_time(fixed(method, 32), b)
        t64 = chained_op_time(fixed(method, 64), b)
        per = (t64 - t32) / 32
        out["fixed"][method] = (t32, t64, per)
        log(f"{method:9s} 32 iters {t32 * 1e3:8.2f} ms  64 iters "
            f"{t64 * 1e3:8.2f} ms  per-iter {per * 1e6:7.1f} us")

    # CA-GMRES's basis length (min(restart, 16)) governs its conditioning:
    # swept for the monomial basis and the Leja-shifted Newton basis
    for method, restart, basis in SWEEP:
        kv = dataclasses.replace(krylov, method=method, restart=restart,
                                 ca_basis=basis)
        if method == "ca_gmres" and basis == "newton":
            # shifts for this basis length
            solver._ca_shifts = solver._build_ca_shifts(prep,
                                                        min(restart, 16))
        r = solver._solve_prepared(prep, b, kv)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(5):
            r = solver._solve_prepared(prep, b, kv)
        _sync(device)
        ms = (time.perf_counter() - t0) / 5 * 1e3
        if method == "ca_gmres":
            tag = f"{method}[m={min(restart, 16)},{basis[:4]}]"
        else:
            tag = f"{method}[{restart}]"
        out["sweep"][sweep_name(method, restart, basis)] = (
            ms, int(r.iters), float(r.resnorm), bool(r.converged))
        log(f"{tag:19s} to tol: {ms:8.2f} ms  iters={int(r.iters)} "
            f"resnorm={float(r.resnorm):.3e} converged={bool(r.converged)}")
    return out


if __name__ == "__main__":
    main()
