"""CG, the preconditioner host oracles, CA-GMRES and deflation (ROADMAP
slices 11, 12, 13) of the PyTorch package against the JAX package's, and
every ValueError the port raises for the options of these slices and of
the reference Jacobian and the coarse variants."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.config import NSConfig as JNS
from navierstokes_tpu.config import SolverConfig as JSolver
from navierstokes_tpu.fem import assembly as jas
from navierstokes_tpu.fem.dirichlet import zero_rows_bcsr as j_zero_rows
from navierstokes_tpu.mesh import channel_mesh as j_channel
from navierstokes_tpu.model import NavierStokesSolver as JModel
from navierstokes_tpu.solvers import cg as j_cg
from navierstokes_tpu.solvers import precond as jpc
from navierstokes_tpu.solvers import sstep as jss
from navierstokes_tpu.sparse.bcsr import BCSR4 as JBCSR4
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.config import NSConfig, SolverConfig
from navierstokes_tpu_torch.config import resolve_supported
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.model.navier_stokes import DeflatedPrep
from navierstokes_tpu_torch.solvers import precond as pc
from navierstokes_tpu_torch.solvers.cg import cg
from navierstokes_tpu_torch.solvers.gmres import gmres
from navierstokes_tpu_torch.solvers.sstep import (
    ca_gmres,
    leja_order,
    newton_shifts,
)
from navierstokes_tpu_torch.sparse.bcsr import bcsr_matvec

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def system():
    """The JAX solver tests' system: channel(3,2,2) linear terms with BC
    rows zeroed, f64; the JAX BCSR4, the port's, and the BC right-hand
    side."""
    mesh = j_channel(3, 2, 2, length=2.0)
    disc = jas.build_discretization(mesh, dtype=jnp.float64)
    op = jas.assemble_operator(disc, jnp.zeros(disc.ndof), 0.01, 50.0, 0.1,
                               jas.LINEAR_TERMS)
    values = j_zero_rows(op.values, disc.row_ids, jnp.asarray(disc.indices),
                         disc.diag_slots, disc.bc.row_bc)
    jop = JBCSR4(indptr=op.indptr, indices=op.indices, values=values)
    return disc, jop, convert.bcsr_from_jax(jop), np.asarray(disc.bc.value)


def test_cg_on_spd_pressure_block(system):
    """CG on the SPD pressure-stabilization block + 0.1 I (the JAX test's
    system): the JAX package's count and solution at rel 1e-10, the dense
    solve at its bars."""
    _, jop, _, _ = system
    dense = np.asarray(jop.to_dense())
    p = np.arange(3, dense.shape[0], 4)
    Dp = dense[np.ix_(p, p)] + 0.1 * np.eye(len(p))
    Dp = 0.5 * (Dp + Dp.T)
    b = np.random.default_rng(0).standard_normal(len(p))
    jr = j_cg(lambda x: jnp.asarray(Dp) @ x, jnp.asarray(b), rtol=1e-12,
              atol=1e-14, maxiter=2000)
    Dt = torch.as_tensor(Dp)
    res = cg(lambda x: Dt @ x, torch.as_tensor(b), rtol=1e-12, atol=1e-14,
             maxiter=2000)
    assert res.converged and res.iters == int(jr.iters)
    assert _rel(res.x.numpy(), jr.x) <= 1e-10
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(Dp, b),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("level", [0, 1])
def test_ilu_oracle_matches_jax(system, level):
    """ILU(k)'s factors, forward and transposed solves against the JAX
    package's at rel 1e-12, and the solves against the densified
    factors."""
    _, jop, op, _ = system
    jilu = jpc.ILU0Preconditioner(jop, level=level)
    ilu = pc.make_preconditioner("ilu", op, None, level=level)
    assert np.array_equal(ilu.indptr, jilu.indptr)
    assert np.array_equal(ilu.indices, jilu.indices)
    assert _rel(ilu.vals, jilu.vals) <= 1e-12
    r = np.random.default_rng(3).standard_normal(4 * ilu.nb)
    for name in ("solve_host", "solve_host_transpose"):
        assert _rel(getattr(ilu, name)(r), getattr(jilu, name)(r)) <= 1e-12
    x = ilu(torch.as_tensor(r), transpose=True)
    assert x.dtype == torch.float64
    assert _rel(x.numpy(), jilu.solve_host_transpose(r)) <= 1e-12


def test_ilu_beats_block_jacobi(system):
    """GMRES with the ILU(0) oracle takes no more iterations than with
    block-Jacobi and reaches the same x at 1e-6 (the JAX test's criterion),
    with the port's block-CSR matvec; block-Jacobi's Neumann boost cuts
    iterations."""
    disc, _, op, rhs = system
    b = torch.tensor(rhs)

    def matvec(x):
        return bcsr_matvec(op, x)

    bj = pc.make_preconditioner("block_jacobi", op, disc.diag_slots)
    res_j = gmres(matvec, b, precond=bj, restart=30, rtol=1e-10, atol=1e-12)
    res_i = gmres(matvec, b, precond=pc.ILU0Preconditioner(op), restart=30,
                  rtol=1e-10, atol=1e-12)
    assert res_j.converged and res_i.converged
    assert res_i.iters <= res_j.iters
    np.testing.assert_allclose(res_i.x.numpy(), res_j.x.numpy(), rtol=0,
                               atol=1e-6)
    bj2 = pc.BlockJacobiPreconditioner.from_bcsr(op, disc.diag_slots,
                                                 matvec=matvec, order=2)
    res_2 = gmres(matvec, b, precond=bj2, restart=30, rtol=1e-10, atol=1e-12)
    assert res_2.iters < res_j.iters
    assert pc.make_preconditioner("none", op, None) is None


def test_leja_order_and_newton_shifts_match_jax():
    rng = np.random.default_rng(7)
    v = rng.standard_normal(20) * 10
    assert np.array_equal(leja_order(v), jss.leja_order(v))
    h = np.triu(rng.standard_normal((13, 12)), -1)
    for s in (8, 27):
        assert newton_shifts(h, s) == jss.newton_shifts(h, s)


@pytest.mark.parametrize("basis", ["monomial", "newton"])
def test_ca_gmres_matches_jax(system, basis):
    """CA-GMRES(8) with block-Jacobi on the system: iteration counts within
    1 of the JAX package's and x at rel 1e-8; the Newton basis from the
    same Leja-ordered shifts."""
    disc, jop, op, rhs = system
    dense = np.asarray(jop.to_dense())
    jbj = jpc.BlockJacobiPreconditioner.from_bcsr(jop, disc.diag_slots)
    bj = pc.BlockJacobiPreconditioner.from_bcsr(op, disc.diag_slots)
    shifts = None
    if basis == "newton":
        from navierstokes_tpu.solvers.deflation import arnoldi as j_arnoldi

        _, h = j_arnoldi(lambda x: jbj(jnp.asarray(dense) @ x),
                         jnp.asarray(rhs), 32)
        shifts = jss.newton_shifts(np.asarray(h), 8)
    kw = dict(basis=8, rtol=1e-10, atol=1e-12, maxiter=2000, shifts=shifts)
    jr = jss.ca_gmres(lambda x: jnp.asarray(dense) @ x, jnp.asarray(rhs),
                      precond=jbj, **kw)
    res = ca_gmres(lambda x: bcsr_matvec(op, x), torch.as_tensor(rhs),
                   precond=bj, **kw)
    assert bool(jr.converged) and res.converged
    assert abs(res.iters - int(jr.iters)) <= 1
    assert _rel(res.x.numpy(), jr.x) <= 1e-8


def _defl_cfg(**kw):
    kr = JSolver(rtol=1e-12, atol=1e-13, maxiter=4000,
                 preconditioner="two_level", coarse_agg=4, **kw)
    return JNS(dt=0.01, reynolds=100.0, delta=0.1, dtype="float64",
               krylov=kr, stokes_krylov=dataclasses.replace(kr,
                                                            deflation_k=0))


@pytest.mark.parametrize("spmv", ["auto", "plane"])
def test_deflated_step_matches_jax(spmv):
    """deflation_k=6 (Arnoldi 24) on 'tl' and 'tlp': one step from one
    state in both packages, equal Newton counts, GMRES counts within 1,
    states at rel 1e-8; the recycled pair is orthonormal (Q Q^T = I) with
    T U^T = Q^T; the undeflated step reaches the same state; the JAX pair
    carried across gives the JAX step."""
    jcfg = _defl_cfg(spmv=spmv, deflation_k=6, deflation_arnoldi=24)
    jmesh = j_channel(6, 3, 3, obstacle=True)
    js = JModel(jmesh, jcfg)
    ts = NavierStokesSolver(convert.mesh_from_jax(jmesh),
                            convert.config_from_jax(jcfg), device=CPU)
    ut = ts.stokes_init()
    ts._ensure_prepared()
    prep = ts._exact_prep
    assert isinstance(prep, DeflatedPrep) and js._exact_prep[0] == "defl"
    k = prep.Q.shape[0]
    assert k == 6 and prep.U.shape == prep.Q.shape
    np.testing.assert_allclose((prep.Q @ prep.Q.T).numpy(), np.eye(k),
                               atol=1e-10)
    mv, _, _ = ts._prep_operators(prep.inner)
    TU = torch.stack([mv(u) for u in prep.U])
    assert _rel(TU.numpy(), prep.Q.numpy()) <= 1e-8
    z = torch.zeros_like(ut)
    ut1, _, st = ts.step(ut, ut, z)
    uj = jnp.asarray(ut.numpy())
    uj1, _, sj = js.step(uj, uj, jnp.zeros_like(uj))
    assert st.converged and bool(sj.converged) and st.iters == int(sj.iters)
    assert abs(st.lin_iters - int(sj.lin_iters)) <= 1
    assert _rel(ut1.numpy(), uj1) <= 1e-8
    plain = NavierStokesSolver(ts.disc.mesh, convert.config_from_jax(
        _defl_cfg(spmv=spmv)), disc=ts.disc, device=CPU)
    up, _, _ = plain.step(ut, ut, z)
    assert _rel(ut1.numpy(), up.numpy()) <= 1e-8
    ts._exact_prep = convert.prep_from_jax(js._exact_prep)
    uc, _, _ = ts.step(ut, ut, z)
    assert _rel(uc.numpy(), uj1) <= 1e-8


def test_ca_newton_basis_in_model_matches_jax():
    """method='ca_gmres', ca_basis='newton', restart 8: the port's shifts
    (an Arnoldi sweep on its own prepared operator) equal the JAX
    package's at rel 1e-8, and one step reaches the JAX state at rel
    1e-8 and its own standard-GMRES state at 1e-6 (the JAX test's bar)."""
    kr = JSolver(rtol=1e-10, atol=1e-13, maxiter=4000,
                 preconditioner="two_level", coarse_agg=4,
                 method="ca_gmres", restart=8, ca_basis="newton")
    jcfg = JNS(dt=0.01, reynolds=100.0, delta=0.1, dtype="float64",
               krylov=kr, stokes_krylov=dataclasses.replace(
                   kr, method="gmres", rtol=1e-13))
    jmesh = j_channel(3, 2, 2, length=2.0)
    js = JModel(jmesh, jcfg)
    ts = NavierStokesSolver(convert.mesh_from_jax(jmesh),
                            convert.config_from_jax(jcfg), device=CPU)
    u0 = ts.stokes_init()
    js._ensure_prepared()
    ts._ensure_prepared()
    assert len(ts._ca_shifts) == 8
    assert _rel(ts._ca_shifts, js._ca_shifts) <= 1e-8
    z = torch.zeros_like(u0)
    ut, _, st = ts.step(u0, u0, z)
    uj = jnp.asarray(u0.numpy())
    uj1, _, sj = js.step(uj, uj, jnp.zeros_like(uj))
    assert st.converged and bool(sj.converged)
    assert _rel(ut.numpy(), uj1) <= 1e-8
    std = dataclasses.replace(ts.user_cfg, krylov=dataclasses.replace(
        ts.user_cfg.krylov, method="gmres", rtol=1e-12))
    us, _, _ = NavierStokesSolver(ts.disc.mesh, std, disc=ts.disc,
                                  device=CPU).step(u0, u0, z)
    assert _rel(ut.numpy(), us.numpy()) < 1e-6


_TL = dict(preconditioner="two_level")


@pytest.mark.parametrize("cfg_kw,krylov_kw,match", [
    ({}, dict(preconditioner="ilu0"), "runs block-Jacobi under this name"),
    ({}, dict(preconditioner="none"), "runs block-Jacobi under this name"),
    ({}, dict(coarse_basis="linear"), r"linear'.*\('bj'\).*ignore it"),
    ({}, dict(coarse_smooth_omega=0.5), r"omega=0.5.*\('bj'\).*ignore it"),
    ({}, dict(preconditioner="schur", spmv="plane", coarse_basis="linear"),
     r"\('sch'\).*ignore it"),
    ({}, dict(preconditioner="schur", spmv="plane",
              coarse_smooth_omega=0.5), r"\('sch'\).*ignore it"),
    ({}, dict(_TL, coarse_basis="linear"), "requires spmv='plane'"),
    ({}, dict(_TL, spmv="plane", coarse_basis="linear",
              coarse_smooth_omega=0.5), "mutually exclusive"),
    ({}, dict(_TL, spmv="plane", coarse_basis="linear", coarse_agg=2),
     "dense coarse path only"),
    ({}, dict(_TL, coarse_smooth_omega=0.5, coarse_agg=4,
              coarse_dense_max=64), "dense coarse path only"),
    (dict(jacobian="reference"), dict(_TL, spmv="plane",
                                      coarse_basis="linear"), "eager"),
    (dict(jacobian="reference"), dict(_TL, coarse_smooth_omega=0.5),
     "eager"),
    (dict(jacobian="reference"), dict(_TL, coarse_cheby=3), "eager"),
    (dict(jacobian="reference"), dict(_TL, deflation_k=4),
     "deflation_k requires jacobian='exact'"),
    (dict(jacobian="reference"), dict(method="ca_gmres", ca_basis="newton"),
     "ca_basis='newton' requires jacobian='exact'"),
    (dict(jacobian="reference"), dict(preconditioner="schur", spmv="plane"),
     "jacobian='exact'"),
    ({}, dict(_TL, deflation_k=4, method="ca_gmres"), "method='gmres'"),
    ({}, dict(_TL, deflation_k=4, method="cg"), "method='gmres'"),
    ({}, dict(ca_basis="bogus"), "ca_basis"),
    ({}, dict(method="bicgstab"), "unknown method"),
    (dict(jacobian="newton"), {}, "unknown jacobian"),
])
def test_option_errors(cfg_kw, krylov_kw, match):
    """Where the JAX package refuses an option of these slices, the port
    raises its ValueError at resolution; where the JAX package silently
    runs something else ('ilu0'/'none': block-Jacobi; the coarse options
    under 'bj' and 'sch': ignored), the port raises a ValueError that
    says so.  nv = 1000: n_agg = 21 at coarse_agg 48, so the linear
    basis's nc = 336 fits the dense cap, and 16 * 500 does not."""
    cfg = NSConfig(krylov=SolverConfig(**krylov_kw), **cfg_kw)
    with pytest.raises(ValueError, match=match):
        resolve_supported(cfg, 1000)


def test_ell_slots_not_ported():
    """`ell_slots` resolves as set, and a solve on a channel with it runs
    and equals one without, bit for bit (the block-ELL pattern is built
    at first use only, with the slots asked for); slots below the row
    degree raise the JAX package's ValueError."""
    assert resolve_supported(NSConfig(ell_slots=8), 1000).ell_slots == 8
    mesh = convert.mesh_from_jax(j_channel(4, 2, 2))
    kr = SolverConfig(rtol=1e-10, atol=1e-12, maxiter=400)
    cfg = NSConfig(dt=0.01, reynolds=100.0, delta=0.1, dtype="float64",
                   krylov=kr, stokes_krylov=kr)
    runs = []
    for slots in (None, 30):
        s = NavierStokesSolver(mesh, dataclasses.replace(cfg,
                                                         ell_slots=slots),
                               device="cpu")
        assert s.disc.ell_pattern is None
        runs.append(s.run(1, u0=s.stokes_init(), monitor=False))
        degree = int(np.diff(s.disc.indptr).max())
        assert s.disc.ell_slots == (slots or degree)
        assert s.disc.ell_indices.shape == (mesh.nv, slots or degree)
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="max row degree"):
        NavierStokesSolver(mesh, dataclasses.replace(cfg, ell_slots=8),
                           device="cpu")
