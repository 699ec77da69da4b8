"""The system under test, `navierstokes_tpu_torch`, as the benchmark drives
it: the only module of the benchmark that imports it.

`System` builds the solver the way `python -m navierstokes_tpu_torch.run`
does for a configuration file, and reads the program's own counters: the
Newton and GMRES counts of each step (`NewtonStats`), K1's and K2's
launches by form (`ops/plane_dia.form_launches`, `ops/dia.form_launches`),
the always-on counters (`utils/profiling.counters`: host syncs, CUDA graph
captures, replays and run-ahead), the host seconds of the Schur tier's
Newton preparation (`SchurPrep.seconds`) and the seconds the process spent
in nvcc (`ops/cuda_lib.nvcc_seconds`).  It changes nothing of the solver.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StepResult(NamedTuple):
    u: torch.Tensor
    delta_u: torch.Tensor
    newton: int
    gmres: int
    converged: bool


def solver_config(cfg: dict):
    """The port's NSConfig for a configuration file."""
    from navierstokes_tpu_torch.config import (
        NewtonConfig,
        NSConfig,
        SolverConfig,
    )

    newton = {k: float(v) if isinstance(v, str) else v
              for k, v in cfg["newton"].items()}
    return NSConfig(dt=cfg["dt"], reynolds=cfg["reynolds"],
                    delta=cfg["delta"],
                    stokes_reynolds=cfg["stokes_reynolds"],
                    dtype=cfg["dtype"], newton=NewtonConfig(**newton),
                    krylov=SolverConfig(**cfg["krylov"]),
                    stokes_krylov=SolverConfig(**cfg["stokes_krylov"]))


class System:
    """One solver on one device, built from the benchmark's mesh arrays."""

    def __init__(self, cfg: dict, coords, tets, tags, device):
        from navierstokes_tpu_torch.mesh.core import Mesh
        from navierstokes_tpu_torch.model import NavierStokesSolver
        from navierstokes_tpu_torch.ops import cuda_lib, dia, plane_dia
        from navierstokes_tpu_torch.utils import profiling

        self.device = torch.device(device)
        self._plane_dia = plane_dia
        self._dia = dia
        self._cuda_lib = cuda_lib
        self._counters = profiling.counters
        self.solver = NavierStokesSolver(
            Mesh(coords=coords, tets=tets, node_tags=tags),
            solver_config(cfg), device=self.device)

    @property
    def prep_kind(self) -> str:
        return self.solver.prep_kind

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prepare(self) -> None:
        self.solver._ensure_prepared()

    def stokes(self) -> torch.Tensor:
        return self.solver.stokes_init()

    def stokes_iters(self) -> int:
        return int(self.solver.stokes_result.iters)

    def step(self, u, u_old, delta_u) -> StepResult:
        u_new, du, stats = self.solver.step(u, u_old, delta_u)
        return StepResult(u_new, du, int(stats.iters), int(stats.lin_iters),
                          bool(stats.converged))

    def schur_seconds(self) -> dict:
        """Host seconds per stage of the Schur algebra of the Newton
        preparation, the one the solver holds after `prepare` ({} on
        another tier).  On the Schur tier a preparation that carries no
        seconds raises: the metric would go silent."""
        prep = self.solver._exact_prep
        prep = getattr(prep, "inner", prep)
        seconds = dict(getattr(prep, "seconds", None) or {})
        if self.prep_kind == "sch" and not seconds:
            raise RuntimeError("the Schur preparation recorded no seconds")
        return seconds

    def nvcc_seconds(self) -> float:
        """Seconds this process spent building kernels with nvcc (0 where
        the checkout's build directory held every library)."""
        return float(self._cuda_lib.nvcc_seconds())

    def k1_forms(self) -> dict:
        """K1 launches so far by (n_out, n_in, node offsets, route, halo)."""
        out = {}
        for key, n in self._plane_dia.form_launches.items():
            n_out, n_in = (int(v) for v in key[0].split("x"))
            out[(n_out, n_in, int(key[1]), key[2], "halo" in key)] = n
        return out

    def k2_forms(self) -> dict:
        """K2 launches so far by the program's own form key, as it writes
        it ("<data dtype>/<x dtype>", " halo" for the ghost-row form)."""
        return dict(self._dia.form_launches)

    def counters(self) -> dict:
        """The program's always-on counters now, by name: `syncs`,
        `graph_captures`, `graph_replays`, `graph_ahead`,
        `graph_discarded`."""
        return dict(self._counters())

    def release(self) -> None:
        """Drop every device tensor the solver holds."""
        self.solver = None
