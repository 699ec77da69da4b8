"""The distributed solver of the port against the JAX package's and against
the port's single-device solver, shared by tests/test_torch_distributed.py
and tests/test_torch_parallel.py (two files, so that the workers share
the JAX package's compile time)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from navierstokes_tpu.config import NewtonConfig as JNewton
from navierstokes_tpu.config import NSConfig as JNS
from navierstokes_tpu.config import SolverConfig as JSolver
from navierstokes_tpu.mesh import channel_mesh as j_channel
from navierstokes_tpu.parallel import DistributedNavierStokesSolver as JDist
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.parallel import DistributedNavierStokesSolver

CPU = torch.device("cpu")


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_config(krylov_kw: dict, stokes_rtol: float = 1e-13,
               **cfg_kw) -> JNS:
    """float64, the Krylov solves near round-off (tests/test_parallel.py's
    parity configs)."""
    kr = JSolver(**{"rtol": 1e-12, "atol": 1e-13, "maxiter": 4000,
                    **krylov_kw})
    return JNS(dt=0.01, t_final=0.02, reynolds=100.0, delta=0.1,
               dtype="float64", krylov=kr,
               stokes_krylov=dataclasses.replace(kr, rtol=stokes_rtol),
               **cfg_kw)


def compare_with_jax(krylov_kw: dict, *, P: int = 4, steps: int = 2,
                     mesh=None, cfg_kw=None, newton_kw=None,
                     stokes_rtol: float = 1e-13, stokes_converges=True,
                     gmres_slack: int = 2) -> list:
    """Stokes in the port on one device and distributed over [cpu] * P
    (rel 1e-8, GMRES within `gmres_slack`); then `steps` steps, each from
    the same state (the JAX package's), of the JAX package's distributed
    solver on P virtual devices, the port's distributed solver and its
    single-device solver: states within rel 1e-8, Newton counts equal,
    GMRES within `gmres_slack` per Newton solve.  Returns the port's
    distributed step stats."""
    cfg_kw = dict(cfg_kw or {})
    if newton_kw:
        cfg_kw["newton"] = JNewton(**newton_kw)
    jcfg = jax_config(krylov_kw, stokes_rtol, **cfg_kw)
    jmesh = mesh if mesh is not None else j_channel(12, 2, 2, length=6.0)
    tmesh = convert.mesh_from_jax(jmesh)
    tcfg = convert.config_from_jax(jcfg)
    jd, jperm = JDist.from_mesh(jmesh, jcfg, devices=jax.devices()[:P])
    td, tperm = DistributedNavierStokesSolver.from_mesh(
        tmesh, tcfg, devices=[CPU] * P)
    np.testing.assert_array_equal(tperm, np.asarray(jperm))
    np.testing.assert_array_equal(tperm, np.arange(tmesh.nv))
    single = NavierStokesSolver(tmesh, tcfg, device=CPU)
    assert td.prep_kind == single.prep_kind

    u0 = single.stokes_init()
    ud0 = td.stokes_init()
    assert td.stokes_result.converged == single.stokes_result.converged \
        == stokes_converges
    assert rel(ud0, u0) <= 1e-8
    assert abs(td.stokes_result.iters - single.stokes_result.iters) <= \
        gmres_slack

    u_old, du = u0.numpy(), np.zeros(u0.shape)
    stats = []
    for _ in range(steps):
        uj, duj, sj = jd.step(jnp.asarray(u_old), jnp.asarray(u_old),
                              jnp.asarray(du))
        args = (torch.as_tensor(u_old), torch.as_tensor(u_old),
                torch.as_tensor(du))
        ut, _, st = td.step(*args)
        us, _, ss = single.step(*args)
        assert bool(sj.converged) and st.converged and ss.converged
        assert st.iters == int(sj.iters) == ss.iters
        for other in (int(sj.lin_iters), ss.lin_iters):
            assert abs(st.lin_iters - other) <= gmres_slack * st.iters
        assert rel(ut, uj) <= 1e-8
        assert rel(ut, us) <= 1e-8
        stats.append(st)
        u_old, du = np.array(uj), np.array(duj)
    return stats
