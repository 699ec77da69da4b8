"""The reference Jacobian and the element-wise residual (ROADMAP slices 2
and 5): the PyTorch package's assembly of the residual, the nonlinear DIA
operator and the block-CSR operator against the JAX package's at rel
1e-12; a reference-mode step against the JAX package's at rel 1e-9; the
bars of the JAX package's own mode checks (`tests/test_newton_e2e.py`);
the golden trajectory in reference mode at 1e-8; and
`release_assembly_buffers`."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.config import NSConfig as JNS
from navierstokes_tpu.config import SolverConfig as JSolver
from navierstokes_tpu.fem import assembly as jas
from navierstokes_tpu.fem.dirichlet import zero_rows_bcsr as j_zero_rows_bcsr
from navierstokes_tpu.mesh import channel_mesh as j_channel
from navierstokes_tpu.model import NavierStokesSolver as JModel
from navierstokes_tpu.sparse.bcsr import bcsr_from_coo as j_bcsr_from_coo
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu_torch.fem.assembly import (
    FULL_JACOBIAN_TERMS,
    LINEAR_TERMS,
    NONLINEAR_TERMS,
    assemble_dia_values,
    assemble_operator,
    assemble_residual,
    build_discretization,
    local_fields,
)
from navierstokes_tpu_torch.fem.dirichlet import zero_rows_bcsr
from navierstokes_tpu_torch.mesh import channel_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.sparse.bcsr import bcsr_from_coo, bcsr_matvec
from navierstokes_tpu_torch.utils import profiling

from data_golden_trajectory import TRAJ

torch.set_num_threads(1)
CPU = torch.device("cpu")
DT, RE, DELTA = 0.01, 100.0, 0.1


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def discs():
    """channel(4,2,2) with an obstacle in both packages, f64, and a seeded
    random state pair."""
    jmesh = j_channel(4, 2, 2, obstacle=True)
    jd = jas.build_discretization(jmesh, dtype=jnp.float64)
    td = build_discretization(convert.mesh_from_jax(jmesh), torch.float64,
                              CPU)
    rng = np.random.default_rng(7)
    u, u_old = rng.standard_normal((2, td.ndof))
    return jd, td, u, u_old


def test_local_fields_and_residual_match_jax(discs):
    jd, td, u, u_old = discs
    jUL, jPL = jas.local_fields(jd.tets, jnp.asarray(u))
    UL, PL = local_fields(td.tets, torch.as_tensor(u))
    assert np.array_equal(UL.numpy(), jUL) and np.array_equal(PL.numpy(), jPL)
    want = jas.assemble_residual(jd.tets, jd.vol, jd.grad, jd.h,
                                 jnp.asarray(u), jnp.asarray(u_old), DT, RE,
                                 DELTA, ndof=jd.ndof)
    got = assemble_residual(td.tets, td.vol, td.grad, td.h,
                            torch.as_tensor(u), torch.as_tensor(u_old), DT,
                            RE, DELTA, ndof=td.ndof)
    assert _rel(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("name,terms", [("nonlinear", NONLINEAR_TERMS),
                                        ("full", FULL_JACOBIAN_TERMS)])
@pytest.mark.parametrize("chunk", [16384, 7])
def test_nonlinear_dia_assembly_matches_jax(discs, name, terms, chunk):
    """The convection terms at a state, straight into the scalar-DIA
    layout, whole and in chunks of 7 elements."""
    jd, td, u, _ = discs
    jUL, _ = jas.local_fields(jd.tets, jnp.asarray(u))
    want = jas.assemble_dia_values(
        jd.tets, jd.vol, jd.grad, jd.h, jUL, DT, RE, DELTA, jd.dia_elem_map,
        terms=terms, K=jd.dia_pattern.K, ndof=jd.ndof)
    UL, _ = local_fields(td.tets, torch.as_tensor(u))
    got = assemble_dia_values(td.vol, td.grad, td.h, DT, RE, DELTA,
                              td.dia_elem_map, terms=terms,
                              K=td.dia_pattern.K, ndof=td.ndof, chunk=chunk,
                              UL=UL)
    assert _rel(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("name,terms", [("linear", LINEAR_TERMS),
                                        ("full", FULL_JACOBIAN_TERMS)])
def test_assemble_operator_matches_jax(discs, name, terms):
    """The block-CSR route: pattern equal, values at rel 1e-12, the BC rows
    zeroed as the JAX package zeroes them, and the block matvec equal to
    the dense product."""
    jd, td, u, _ = discs
    jop = jas.assemble_operator(jd, jnp.asarray(u), DT, RE, DELTA, terms)
    op = assemble_operator(td, torch.as_tensor(u), DT, RE, DELTA, terms)
    assert np.array_equal(op.indptr, jop.indptr)
    assert np.array_equal(op.indices, jop.indices)
    assert np.array_equal(td.diag_slots, jd.diag_slots)
    assert np.array_equal(td.row_ids, jd.row_ids) and td.nnzb == jd.nnzb
    assert _rel(op.values.numpy(), jop.values) <= 1e-12
    assert _rel(op.to_dense(), jop.to_dense()) <= 1e-12
    jz = j_zero_rows_bcsr(jop.values, jd.row_ids, jnp.asarray(jd.indices),
                          jd.diag_slots, jd.bc.row_bc)
    z = zero_rows_bcsr(op.values, td.row_ids, td.indices, td.diag_slots,
                       td.bc.row_bc)
    assert _rel(z.numpy(), jz) <= 1e-12
    x = np.random.default_rng(3).standard_normal(td.ndof)
    y = bcsr_matvec(op, torch.as_tensor(x)).numpy()
    assert _rel(y, op.to_dense() @ x) <= 1e-13
    conv = convert.bcsr_from_jax(jop)
    assert np.array_equal(conv.values.numpy(), np.asarray(jop.values))
    # block COO triplets with duplicates, summed
    rng = np.random.default_rng(11)
    rows, cols = rng.integers(0, 6, (2, 40))
    blocks = rng.standard_normal((40, 4, 4))
    want = j_bcsr_from_coo(rows, cols, jnp.asarray(blocks), 6)
    got = bcsr_from_coo(rows, cols, torch.as_tensor(blocks), 6)
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert _rel(got.values.numpy(), want.values) <= 1e-14


# the JAX package's test_newton_e2e.py config, on its channel(3,2,2)
CFG = NSConfig(
    dt=0.01, t_final=0.03, reynolds=100.0, delta=0.1, dtype="float64",
    krylov=SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000,
                        neumann_order=2),
    stokes_krylov=SolverConfig(rtol=1e-13, atol=1e-13, maxiter=4000,
                               neumann_order=2))


@pytest.fixture(scope="module")
def e2e():
    mesh = channel_mesh(3, 2, 2, length=2.0)
    base = NavierStokesSolver(mesh, CFG, device=CPU)
    u0 = base.stokes_init()
    return mesh, base, u0


def _step(mesh, cfg, u0, disc):
    s = NavierStokesSolver(mesh, cfg, disc=disc, device=CPU)
    return s.step(u0, u0, torch.zeros_like(u0))


def test_exact_and_reference_jacobian_agree(e2e):
    """Both Jacobian modes reach the residual's root at 1e-8 (the bar of
    the JAX package's test); 'exact' needs no more Newton iterations;
    reference mode spans each iteration's assembly and preparation
    (`newton.jacobian`, `newton.prep`), the exact Jacobian neither."""
    mesh, base, u0 = e2e
    log = profiling.enable()
    try:
        u_e, _, st_e = base.step(u0, u0, torch.zeros_like(u0))
        exact = log.snapshot()
        u_r, _, st_r = _step(mesh, dataclasses.replace(
            CFG, jacobian="reference"), u0, base.disc)
    finally:
        profiling.disable()
    spans = log.snapshot()
    assert st_e.converged and st_r.converged
    assert st_e.iters <= st_r.iters
    assert _rel(u_e.numpy(), u_r.numpy()) < 1e-8
    assert not {k for k in exact if k[0].startswith("newton.") and
                k[0] != "newton.check"}
    for name in ("newton.jacobian", "newton.prep"):
        assert spans[(name, "step")][0] == st_r.iters - 1
    assert spans[("krylov.solve", "step")][0] == \
        st_e.iters - 1 + st_r.iters - 1


def test_residual_modes_agree(e2e):
    """Operator-form residual and element-wise residual at 1e-10; every
    value other than 'operator' ('elementwise', 'reference') is the
    element-wise residual, as in the JAX package."""
    mesh, base, u0 = e2e
    u_op, _, _ = base.step(u0, u0, torch.zeros_like(u0))
    u_el, _, st = _step(mesh, dataclasses.replace(CFG, residual="elementwise"),
                        u0, base.disc)
    u_ref, _, _ = _step(mesh, dataclasses.replace(CFG, residual="reference"),
                        u0, base.disc)
    assert st.converged
    assert _rel(u_op.numpy(), u_el.numpy()) < 1e-10
    assert np.array_equal(u_el.numpy(), u_ref.numpy())


def test_reference_mode_step_matches_jax():
    """One step in reference mode (element-wise residual) on 'bj' against
    the JAX package at rel 1e-9 with equal Newton counts; the same step on
    'tlp' (planes re-extracted per iteration) and on 'tl' ('auto', which
    resolves to plain two_level, no Chebyshev, as in the JAX package)
    reaches the JAX state at rel 1e-9 with the same Newton count."""
    kr = JSolver(rtol=1e-12, atol=1e-13, maxiter=4000)
    jcfg = JNS(dt=0.01, reynolds=100.0, delta=0.1, dtype="float64",
               jacobian="reference", residual="reference", krylov=kr,
               stokes_krylov=kr)
    jmesh = j_channel(4, 2, 2, obstacle=True)
    js = JModel(jmesh, jcfg)
    ts = NavierStokesSolver(convert.mesh_from_jax(jmesh),
                            convert.config_from_jax(jcfg), device=CPU)
    assert ts.prep_kind == "bj"
    uj = js.stokes_init()
    ut = ts.stokes_init()
    assert _rel(ut.numpy(), uj) <= 1e-9
    uj1, _, sj = js.step(uj, uj, jnp.zeros_like(uj))
    assert bool(sj.converged) and int(sj.iters) > 2
    u0 = torch.tensor(np.asarray(uj))
    solvers = [ts]
    for krylov_kw, kind in (
            (dict(preconditioner="two_level", spmv="plane", coarse_agg=4),
             "tlp"),
            (dict(preconditioner="auto", spmv="auto"), "tl")):
        kr2 = dataclasses.replace(ts.user_cfg.krylov, **krylov_kw)
        s = NavierStokesSolver(ts.disc.mesh, dataclasses.replace(
            ts.user_cfg, krylov=kr2, stokes_krylov=kr2), disc=ts.disc,
            device=CPU)
        assert s.prep_kind == kind and s.cfg.krylov.coarse_cheby == 0
        solvers.append(s)
    for s in solvers:
        ut1, _, st = s.step(u0, u0, torch.zeros_like(u0))
        assert st.converged and st.iters == int(sj.iters), s.prep_kind
        assert _rel(ut1.numpy(), uj1) <= 1e-9, s.prep_kind


def test_golden_trajectory_reference_mode():
    """The reference-derived 5-step trajectory (tests/data_golden_trajectory)
    in the golden corpus's own mode, with the config of
    tests/test_golden_trajectory.py: reference Jacobian, element-wise
    residual, block-Jacobi, at 1e-8."""
    golden = np.asarray(TRAJ)
    kr = SolverConfig(rtol=1e-13, atol=1e-14, maxiter=4000)
    cfg = NSConfig(dt=1e-3, t_final=5e-3, reynolds=100.0, delta=0.1,
                   dtype="float64", jacobian="reference",
                   residual="reference", krylov=kr, stokes_krylov=kr,
                   newton=NewtonConfig(rtol=1e-6, atol=1e-8, stol=1e-10,
                                       max_iter=30))
    s = NavierStokesSolver(channel_mesh(4, 2, 2), cfg, device=CPU)
    assert s.prep_kind == "bj"
    u = s.stokes_init()
    assert _rel(u.numpy(), golden[0]) < 1e-8
    u_old, du = u, torch.zeros_like(u)
    for step in range(1, 6):
        u, du, st = s.step(u, u_old, du)
        u_old = u
        assert st.converged
        err = _rel(u.numpy(), golden[step])
        assert err < 1e-8, f"step {step}: {err:.2e}"


def test_f64_slow_convergence_not_truncated():
    """The f32 no-progress exit must not fire in float64: in reference mode
    Newton is a fixed-point iteration whose contraction may exceed 0.9 per
    iteration while it converges (the JAX package's test: dt=1.4,
    Re=1400, ~36 iterations).  The JAX test's Newton and Krylov tolerances
    on 'tlp' instead of block-Jacobi: the linear solves are near exact
    either way, so Newton takes the same 36 iterations, and 'tlp' takes
    some 55 GMRES iterations per solve where block-Jacobi takes 230."""
    kr = SolverConfig(rtol=1e-12, atol=1e-14, maxiter=4000,
                      preconditioner="two_level", spmv="plane", coarse_agg=4)
    cfg = NSConfig(
        dt=1.4, t_final=5.6, reynolds=1400.0, delta=0.1, dtype="float64",
        jacobian="reference", residual="reference",
        newton=NewtonConfig(rtol=1e-4, atol=1e-12, max_iter=100,
                            du_tol=float("inf")),
        krylov=kr, stokes_krylov=kr)
    s = NavierStokesSolver(channel_mesh(4, 2, 2), cfg, device=CPU)
    u0 = s.stokes_init()
    _, _, st = s.step(u0, u0, torch.zeros_like(u0))
    it = st.iters
    ratios = st.res_hist[1:it] / st.res_hist[:it - 1]
    assert st.converged, f"truncated at it={it}, ratios={ratios[:8]}"
    assert (ratios[2:] >= 0.9).sum() >= 5
    assert it > 20


def test_ca_gmres_method_in_model(e2e):
    """method='ca_gmres' (monomial basis, rtol 1e-10) reaches the standard
    GMRES state at 1e-6, the JAX package's bar."""
    mesh, base, u0 = e2e
    cfg = dataclasses.replace(
        CFG,
        krylov=dataclasses.replace(CFG.krylov, method="ca_gmres", rtol=1e-10),
        stokes_krylov=dataclasses.replace(CFG.stokes_krylov,
                                          method="ca_gmres", rtol=1e-10))
    u_std, _, st1 = base.step(u0, u0, torch.zeros_like(u0))
    u_ca, _, st2 = _step(mesh, cfg, u0, base.disc)
    assert st1.converged and st2.converged
    assert _rel(u_ca.numpy(), u_std.numpy()) < 1e-6


def test_release_assembly_buffers_preserves_stepping():
    """After `release_assembly_buffers` the exact/operator transient goes on
    bit for bit; in any other mode (which assembles per Newton iteration)
    it raises RuntimeError and frees nothing, as in the JAX package."""
    kr = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=2000)
    cfg = NSConfig(dt=0.01, reynolds=100.0, delta=0.1, dtype="float64",
                   krylov=kr, stokes_krylov=kr)
    mesh = channel_mesh(6, 3, 3, length=3.0)
    ref = NavierStokesSolver(mesh, cfg, device=CPU)
    u0 = ref.stokes_init()
    z = torch.zeros_like(u0)
    u_ref, _, _ = ref.step(u0, u0, z)
    rel = NavierStokesSolver(mesh, cfg, device=CPU)
    u0b = rel.stokes_init()
    assert torch.equal(u0, u0b)
    rel.release_assembly_buffers()
    assert rel.disc.dia_elem_map is None and rel.disc.grad is None
    u_rel, _, st = rel.step(u0b, u0b, z)
    assert st.converged and torch.equal(u_ref, u_rel)
    for mode in (dict(jacobian="reference"), dict(residual="elementwise")):
        other = NavierStokesSolver(mesh, dataclasses.replace(cfg, **mode),
                                   device=CPU)
        with pytest.raises(RuntimeError, match="jacobian='exact' and "
                                               "residual='operator'"):
            other.release_assembly_buffers()
        assert other.disc.dia_elem_map is not None
