"""Transient Navier–Stokes CLI on PyTorch — the ported `solve_newton` main().

    python -m navierstokes_tpu_torch.run --matrix-id 6 --steps 5
    python -m navierstokes_tpu_torch.run --matrix-id 6 --re 300 --dt 1e-3 \
        --t-final 1.0 --delta 0.05 --save --save-dir res
    python -m navierstokes_tpu_torch.run --matrix-id 6 --spmv pallas --steps 5
    python -m navierstokes_tpu_torch.run --matrix-id 6 --cgs2 pallas --steps 5
    python -m navierstokes_tpu_torch.run --matrix-id 9 --steps 5
    python -m navierstokes_tpu_torch.run --nx 4 --ny 2 --nz 2 --steps 2 \
        --device cpu
    python -m navierstokes_tpu_torch.run --msh mesh.msh --save --vtu
    python -m navierstokes_tpu_torch.run --matrix-id 6 --steps 4 \
        --checkpoint ck.npz --checkpoint-every 2 --profile
    python -m navierstokes_tpu_torch.run --matrix-id 6 --steps 4 \
        --resume ck.npz

Runs on one device (`--device`, default `cuda`; `cpu` runs the kernels'
plain PyTorch versions).  As in the JAX CLI, `--dtype` defaults to float32
on the card and float64 on the CPU.  float32 is the flagship
configuration: the measured Newton tolerances and `default_f32_krylov()`,
whose 'auto' preconditioner takes the Schur tier above 150k rows
(matrices 7-10).  float64 takes the JAX CLI's float64 defaults:
`SolverConfig()`, which is block-Jacobi with a Neumann-2 boost on the
scalar-DIA layout.  The Krylov
flags override both the Newton and the Stokes solver configs.  Per-step
output mirrors the reference Newton monitor; `--save` writes PETSc-ASCII
`solution_stepNNNN.dat` files byte-compatible with the golden corpus, and
with `--vtu` also `solution_NNNN.vtu` and `time_series.pvd`.  `--msh`
reads a Gmsh 2.2 file as it is numbered (no reordering).
`--checkpoint PATH --checkpoint-every N` writes the state every N steps;
`--resume PATH` goes on from it, without the Stokes solve, to the same
final step as the uninterrupted run (`--steps` or t_final / dt counts from
0).  `--profile` prints the event table of setup, Stokes and the time loop.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch


def default_f32_krylov():
    """The flagship f32 Krylov defaults: 'auto' preconditioner (two-level
    with a degree-3 Chebyshev smoother up to 150k rows, the pressure-Schur
    tier with a degree-2 Chebyshev velocity smoother above) on the plane
    layout, coarse_agg from the measured size schedule."""
    from navierstokes_tpu_torch.config import SolverConfig

    return SolverConfig(rtol=1e-5, atol=1e-6, maxiter=1000,
                        neumann_order=0, preconditioner="auto",
                        spmv="plane")


@dataclasses.dataclass
class RunOutput:
    """What `main` ran: final state, the solver (with its per-step history
    and Stokes result; None after `--resume`) and wall seconds, each read
    after a device sync (`stokes_s` is the checkpoint load on a resume)."""

    u: torch.Tensor
    solver: object
    setup_s: float
    stokes_s: float
    prep_s: float
    steps_s: float


# CLI flags that override SolverConfig fields of the same name.
_KRYLOV_FLAGS = ("spmv", "preconditioner", "neumann_order", "coarse_agg",
                 "coarse_ml_smooth", "coarse_ml_cycles", "coarse_ml_damp",
                 "coarse_smooth_omega", "coarse_basis", "coarse_cheby",
                 "coarse_cheby_fraction", "schur_cheby", "schur_v_cheby",
                 "schur_shape", "restart", "cgs2")

# Flags of the JAX CLI whose slices are not ported: set, they raise.
_NOT_PORTED = {
    "deflation_k": ("--deflation-k", 13, "deflation"),
    "deflation_arnoldi": ("--deflation-arnoldi", 13, "deflation"),
    "ca_gmres": ("--ca-gmres", 12, "CA-GMRES"),
    "ca_basis": ("--ca-basis", 12, "CA-GMRES"),
}


def main(argv=None) -> Optional[RunOutput]:
    p = argparse.ArgumentParser(
        description="Transient NS solver on PyTorch (one device)")
    p.add_argument("--matrix-id", type=int,
                   help="synthetic scaling-series mesh 1-10")
    p.add_argument("--nx", type=int, help="custom channel mesh nx")
    p.add_argument("--ny", type=int, default=None)
    p.add_argument("--nz", type=int, default=None)
    p.add_argument("--obstacle", action="store_true")
    p.add_argument("--re", type=float, default=300.0)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--t-final", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=None,
                   help="override number of steps")
    p.add_argument("--delta", type=float, default=0.05)
    p.add_argument("--dtype", default=None, choices=["float32", "float64"],
                   help="default: float32 on cuda, float64 on cpu")
    p.add_argument("--save", action="store_true")
    p.add_argument("--save-dir", default="res")
    p.add_argument("--save-every", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--cpu", action="store_true",
                   help="the JAX CLI's flag: the same as --device cpu")
    # Krylov knobs, applied to both the Newton and the Stokes solver.
    p.add_argument("--spmv", choices=["auto", "xla", "pallas", "plane"],
                   default=None,
                   help="operator layout and kernel: plane = K1 on the "
                        "component-plane layout (two_level); auto/pallas = "
                        "K2 on the scalar-DIA layout; xla = K2's plain "
                        "version, kernel-free (debugging)")
    p.add_argument("--preconditioner", default=None,
                   choices=["auto", "block_jacobi", "two_level", "schur",
                            "ilu0", "none"],
                   help="auto (the f32 default) = two_level + coarse_cheby=3 "
                        "up to 150k rows, schur + schur_v_cheby=2 above")
    p.add_argument("--neumann-order", type=int, default=None,
                   help="Neumann-series boost of block-Jacobi")
    p.add_argument("--coarse-agg", type=int, default=None,
                   help="two_level: nodes per aggregate")
    p.add_argument("--coarse-ml-smooth", type=int, default=None,
                   help="multilevel coarse: smoothing sweeps per cycle")
    p.add_argument("--coarse-ml-cycles", type=int, default=None,
                   help="multilevel coarse: two-grid cycles per apply")
    p.add_argument("--coarse-ml-damp", type=float, default=None,
                   help="damping of the level-1 Jacobi sweeps")
    p.add_argument("--coarse-smooth-omega", type=float, default=None,
                   help="smoothed-aggregation prolongator damping (not "
                        "ported: slice 10)")
    p.add_argument("--coarse-basis", default=None,
                   choices=["const", "linear"],
                   help="coarse basis per aggregate (linear is not ported: "
                        "slice 10)")
    p.add_argument("--coarse-cheby", type=int, default=None,
                   help="two_level post-smoother: degree-d Chebyshev sweep "
                        "in D^{-1}A (0 = one Jacobi application)")
    p.add_argument("--coarse-cheby-fraction", type=float, default=None,
                   help="lower end of the Chebyshev interval as a fraction "
                        "of lmax")
    p.add_argument("--schur-cheby", type=int, default=None,
                   help="schur: Chebyshev degree of the S_hat smoother "
                        "(0 = one Jacobi application)")
    p.add_argument("--schur-v-cheby", type=int, default=None,
                   help="schur: Chebyshev degree of the velocity smoother "
                        "(0 = one block-Jacobi application)")
    p.add_argument("--schur-shape", default=None, choices=["lower", "full"],
                   help="schur: block-triangular shape (full adds the B^T "
                        "velocity correction)")
    p.add_argument("--restart", type=int, default=None,
                   help="GMRES restart length")
    p.add_argument("--cgs2", default=None,
                   choices=["xla", "pallas", "pallas_comp"],
                   help="GMRES orthogonalization: xla = four GEMVs per "
                        "step; pallas = the fused CGS2 projection, kernel "
                        "K3; pallas_comp = K3 with compensated h sums")
    p.add_argument("--msh", help="Gmsh 2.2 mesh file")
    p.add_argument("--vtu", action="store_true",
                   help="with --save, also write .vtu files and a .pvd")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file (.npz) to write")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write the checkpoint every N steps")
    p.add_argument("--resume", default=None,
                   help="checkpoint to go on from (skips the Stokes solve)")
    p.add_argument("--profile", action="store_true",
                   help="print an event-log report at the end")
    # Flags of the JAX CLI whose slices are not ported yet: they raise.
    p.add_argument("--devices", type=int, default=0,
                   help=">1: distributed solver (not ported)")
    p.add_argument("--deflation-k", type=int, default=None,
                   help="(not ported)")
    p.add_argument("--deflation-arnoldi", type=int, default=None,
                   help="(not ported)")
    p.add_argument("--ca-gmres", action="store_true", help="(not ported)")
    p.add_argument("--ca-basis", default=None,
                   choices=["monomial", "newton"], help="(not ported)")
    args = p.parse_args(argv)

    for name, (what, slice_no, title) in _NOT_PORTED.items():
        if getattr(args, name):
            raise NotImplementedError(
                f"{what} is not ported to navierstokes_tpu_torch yet "
                f"(ROADMAP slice {slice_no}: {title})")
    if args.devices > 1:
        raise NotImplementedError(
            "--devices > 1 is not ported to navierstokes_tpu_torch yet "
            "(ROADMAP slice 15: distribution)")

    from navierstokes_tpu_torch.config import (
        NewtonConfig,
        NSConfig,
        SolverConfig,
    )
    from navierstokes_tpu_torch.io.checkpoint import load_checkpoint
    from navierstokes_tpu_torch.mesh.box import (
        channel_mesh,
        scaling_series_mesh,
    )
    from navierstokes_tpu_torch.mesh.gmsh import read_gmsh
    from navierstokes_tpu_torch.model import NavierStokesSolver
    from navierstokes_tpu_torch.utils.profiling import EventLog

    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda but no CUDA device is available "
                "(pass --device cpu to run on the CPU)")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    events = EventLog()
    t0 = time.perf_counter()
    if args.msh:
        mesh = read_gmsh(args.msh)
    elif args.matrix_id:
        mesh = scaling_series_mesh(args.matrix_id)
    elif args.nx:
        mesh = channel_mesh(
            args.nx, args.ny or args.nx // 2,
            args.nz or args.ny or args.nx // 2, obstacle=args.obstacle,
        )
    else:
        p.error("one of --msh / --matrix-id / --nx required")

    dtype = args.dtype or ("float64" if device.type == "cpu" else "float32")
    if dtype == "float32":
        # du_tol=inf: with the linear residual, the |F| test alone decides
        newton = NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                              du_tol=float("inf"))
        krylov = default_f32_krylov()
        stokes = default_f32_krylov()
    else:
        newton = NewtonConfig()
        krylov = SolverConfig()
        stokes = SolverConfig(rtol=1e-12, atol=1e-12, maxiter=2000)
    overrides = {field: getattr(args, field) for field in _KRYLOV_FLAGS
                 if getattr(args, field) is not None}
    krylov = dataclasses.replace(krylov, **overrides)
    stokes = dataclasses.replace(stokes, **overrides)
    cfg = NSConfig(
        dt=args.dt, t_final=args.t_final, reynolds=args.re, delta=args.delta,
        dtype=dtype, newton=newton, krylov=krylov, stokes_krylov=stokes,
    )
    n_steps = args.steps if args.steps is not None else cfg.n_steps

    print(f"Matrix size : {4 * mesh.nv}")
    print(f"device={device} dtype={dtype} nodes={mesh.nv} "
          f"tets={mesh.ne}")
    with events.event("setup"):
        solver = NavierStokesSolver(mesh, cfg, device=device)
        sync()
    kr = solver.cfg.krylov
    print(f"preconditioner={kr.preconditioner} spmv={kr.spmv} "
          f"cgs2={kr.cgs2} prep={solver.prep_kind}"
          + (" (kernel-free: K2's plain version)" if kr.spmv == "xla"
             else ""))
    setup_s = time.perf_counter() - t0

    start_step, delta_u0 = 0, None
    t0 = time.perf_counter()
    if args.resume:
        # cfg is the user-level config, the one run() fingerprints its
        # checkpoints with
        start_step, u0, _, delta_u0 = load_checkpoint(args.resume, cfg=cfg)
        print(f"resumed from step {start_step}")
    else:
        print("Solving Stokes system...")
        with events.event("stokes_init"):
            u0 = solver.stokes_init()
            sync()
        st = solver.stokes_result
        print(f"Stokes: lin={st.iters} converged={st.converged}")
    stokes_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    with events.event("operator_prep"):
        solver._ensure_prepared()
        sync()
    prep_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    with events.event("time_loop"):
        u = solver.run(
            max(n_steps - start_step, 0), u0=u0,
            save_dir=args.save_dir if args.save else None,
            save_every=args.save_every if args.save else 0,
            write_vtu_files=args.vtu, monitor=True,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            start_step=start_step, delta_u0=delta_u0,
        )
        sync()
    steps_s = time.perf_counter() - t0
    print(f"Total time: {steps_s:.6f} seconds")
    if args.profile:
        print(events.report())
    return RunOutput(u=u, solver=solver, setup_s=setup_s, stokes_s=stokes_s,
                     prep_s=prep_s, steps_s=steps_s)


if __name__ == "__main__":
    main()
