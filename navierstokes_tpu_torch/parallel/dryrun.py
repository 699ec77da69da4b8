"""Two checks of the distributed path, the port's copies of
`__graft_entry__.py`'s `dryrun_multichip` and its wide phase.

    python -m navierstokes_tpu_torch.parallel.dryrun 4 cuda
    python -m navierstokes_tpu_torch.parallel.dryrun 4 cpu

`dryrun_multichip(n, device)`: one float32 Newton step of the distributed
solver over n shards on `device` (repeated: `[device] * n`) at the CLI's
float32 defaults on a long thin channel, which 'auto' resolves to plain
two_level on the plane layout; every shard's operator apply is K1's
ghost-row form (`shard_kernel_name()`).

`dryrun_wide(n, device)`: matrix 4 (2,541 nodes, obstacle BC tags) in
float64 with the measured aggregate schedule (coarse_agg=None): one step
from one shared Stokes state against the single-device solver on the
same band-ordered mesh, states within rel 1e-8, Newton counts equal,
GMRES within 2.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from navierstokes_tpu_torch.config import (
    NewtonConfig,
    NSConfig,
    SolverConfig,
    auto_coarse_agg,
)
from navierstokes_tpu_torch.mesh.box import channel_mesh, scaling_series_mesh
from navierstokes_tpu_torch.mesh.ordering import reorder_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.ops.plane_dia import node_offsets_from_scalar
from navierstokes_tpu_torch.parallel.distributed import (
    DistributedNavierStokesSolver,
)
from navierstokes_tpu_torch.run import default_f32_krylov


def f32_cfg() -> NSConfig:
    """The CLI's float32 Krylov defaults with the dryrun's tiny aggregate
    and float32 tolerances (`__graft_entry__._f32_cfg`)."""
    krylov = dataclasses.replace(default_f32_krylov(), maxiter=300,
                                 coarse_agg=4)
    return NSConfig(
        dt=0.01, t_final=0.05, reynolds=100.0, delta=0.1, dtype="float32",
        newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6, max_iter=10,
                            du_tol=float("inf")),
        krylov=krylov, stokes_krylov=krylov)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One float32 Newton step over `n_devices` shards of `device`."""
    mesh = channel_mesh(max(6 * n_devices, 12), 2, 2, length=4.0)
    cfg = f32_cfg()
    product = default_f32_krylov()
    assert cfg.krylov.preconditioner == product.preconditioner
    assert cfg.krylov.spmv == product.spmv
    solver, _ = DistributedNavierStokesSolver.from_mesh(
        mesh, cfg, devices=[device] * n_devices)
    u0 = solver.stokes_init()
    u, _, stats = solver.step(u0, u0, torch.zeros_like(u0))
    if not bool(torch.isfinite(u).all()):
        raise AssertionError("non-finite state after the step")
    kernel = solver.shard_kernel_name()
    if kernel != "plane_spmv_halo":
        raise AssertionError(f"distributed routing: shard kernel {kernel}")
    if not stats.converged:
        raise AssertionError(f"the step did not converge: {stats}")
    halo = max(abs(d) for d in solver.disc.dia_pattern.scaled_offsets)
    print(f"dryrun_multichip({n_devices}, {device}): ok - newton_iters="
          f"{stats.iters} lin_iters={stats.lin_iters} shard_spmv={kernel} "
          f"precond={cfg.krylov.preconditioner}->"
          f"{solver.cfg.krylov.preconditioner} spmv={cfg.krylov.spmv} "
          f"scalar_halo={halo} rows/dev={solver.disc.ndof // n_devices}",
          flush=True)
    return {"newton": stats.iters, "gmres": stats.lin_iters}


def dryrun_wide(n_devices: int, device="cuda") -> dict:
    """Matrix 4 in float64: one distributed step against one device."""
    kr = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000,
                      preconditioner="two_level", coarse_agg=None,
                      spmv="plane")
    cfg = NSConfig(
        dt=0.01, t_final=0.02, reynolds=100.0, delta=0.1, dtype="float64",
        newton=NewtonConfig(rtol=1e-10, atol=1e-12, stol=1e-13, max_iter=10,
                            du_tol=float("inf")),
        krylov=kr, stokes_krylov=dataclasses.replace(kr))
    mesh = scaling_series_mesh(4)
    dist, perm = DistributedNavierStokesSolver.from_mesh(
        mesh, cfg, devices=[device] * n_devices)
    agg = dist.cfg.krylov.coarse_agg
    if agg != auto_coarse_agg(dist.disc.ndof):
        raise AssertionError(f"auto aggregate schedule: {agg}")
    if dist.shard_kernel_name() != "plane_spmv_halo":
        raise AssertionError(dist.shard_kernel_name())
    single = NavierStokesSolver(reorder_mesh(mesh, perm), cfg,
                                device=dist.device)
    u0 = single.stokes_init()
    zero = torch.zeros_like(u0)
    ud, _, sd = dist.step(u0, u0, zero)
    us, _, ss = single.step(u0, u0, zero)
    err = float(torch.linalg.norm(ud - us) / torch.linalg.norm(us))
    if not err < 1e-8:
        raise AssertionError(f"distributed vs single-device step: rel "
                             f"{err:.2e}")
    if sd.iters != ss.iters:
        raise AssertionError(f"Newton {sd.iters} vs {ss.iters}")
    if abs(sd.lin_iters - ss.lin_iters) > 2:
        raise AssertionError(f"GMRES {sd.lin_iters} vs {ss.lin_iters}")
    d = dist.disc
    hn = max(max(abs(o) for o in node_offsets_from_scalar(
        d.dia_pattern.offsets)), 1)
    Lb = dist._nbp // n_devices
    print(f"dryrun_wide({n_devices}, {device}): ok - matrix_id=4 ndof="
          f"{d.ndof} auto_agg={agg} newton={sd.iters} lin={sd.lin_iters} "
          f"(single: {ss.lin_iters}) rel_err={err:.1e} nodes/dev={Lb} "
          f"node_halo={hn} halo_bytes/spmv={2 * 4 * hn * 8}", flush=True)
    return {"rel": err, "newton": sd.iters, "gmres": sd.lin_iters,
            "gmres_single": ss.lin_iters}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    dryrun_multichip(n, dev)
    dryrun_wide(n, dev)
