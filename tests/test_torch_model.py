"""The ported slices as a whole: the transient solve of the PyTorch package
against the JAX package on each prepared-operator kind (the 'tlp' flagship,
the scalar two-level 'tl', block-Jacobi 'bj', the multilevel coarse level),
the golden trajectory, the `.dat` writer, the CLI, and the options that
run and that raise."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.config import NewtonConfig as JNewton
from navierstokes_tpu.config import NSConfig as JNS
from navierstokes_tpu.config import SolverConfig as JSolver
from navierstokes_tpu.config import resolve_coarse_defaults as j_resolve
from navierstokes_tpu.io.dat import write_petsc_vec as j_write
from navierstokes_tpu.mesh import channel_mesh as j_channel
from navierstokes_tpu.model import NavierStokesSolver as JSolverModel
from navierstokes_tpu_torch import convert, run
from navierstokes_tpu_torch.config import (
    NewtonConfig,
    NSConfig,
    SolverConfig,
    resolve_supported,
)
from navierstokes_tpu_torch.io.checkpoint import load_checkpoint
from navierstokes_tpu_torch.io.dat import HEADER, read_petsc_vec, write_petsc_vec
from navierstokes_tpu_torch.mesh import channel_mesh, write_gmsh
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.model.navier_stokes import MultilevelCoarse
from navierstokes_tpu_torch.ops import cgs2 as tcgs2
from navierstokes_tpu_torch.ops import dia as tdia
from navierstokes_tpu_torch.ops import plane_dia as tpd
from navierstokes_tpu_torch.parallel import DistributedNavierStokesSolver
from navierstokes_tpu_torch.utils.precision import tf32_off

from data_golden_trajectory import TRAJ

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
_PLANE = dict(preconditioner="two_level", spmv="plane")


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))


def _both_solvers(**krylov_kw):
    """The JAX package's solver and the port's on channel(6,3,3) with an
    obstacle, f64, Krylov rtol 1e-12, from one JAX config."""
    kr = JSolver(rtol=1e-12, atol=1e-13, maxiter=4000, **krylov_kw)
    jcfg = JNS(dt=0.01, t_final=0.03, reynolds=100.0, delta=0.1,
               dtype="float64", krylov=kr, stokes_krylov=kr)
    jmesh = j_channel(6, 3, 3, obstacle=True)
    js = JSolverModel(jmesh, jcfg)
    ts = NavierStokesSolver(convert.mesh_from_jax(jmesh),
                            convert.config_from_jax(jcfg), device=CPU)
    return js, ts


def _port_solver(ts, **krylov_kw):
    """Another port solver on ts's mesh and discretization."""
    kr = dataclasses.replace(ts.user_cfg.krylov, **krylov_kw)
    cfg = dataclasses.replace(ts.user_cfg, krylov=kr, stokes_krylov=kr)
    return NavierStokesSolver(ts.disc.mesh, cfg, disc=ts.disc, device=CPU)


def _match_jax(js, ts, steps=3, same=()):
    """Stokes + `steps` steps in both packages, each step from the same
    (JAX) state: states at rel 1e-9, Newton counts within 1 and GMRES
    counts within 1 per Newton iteration.  The port solvers in `same`
    take the same inputs and must reach ts's states at rel 1e-9."""
    uj = js.stokes_init()
    ut = ts.stokes_init()
    assert ts.stokes_result.converged
    assert _rel(ut.numpy(), uj) <= 1e-9
    for other in same:
        assert _rel(other.stokes_init().numpy(), ut.numpy()) <= 1e-9

    du = np.zeros(uj.shape)
    u_old = np.array(uj)
    for _ in range(steps):
        uj1, duj, sj = js.step(jnp.asarray(u_old), jnp.asarray(u_old),
                               jnp.asarray(du))
        args = (torch.as_tensor(u_old), torch.as_tensor(u_old),
                torch.as_tensor(du))
        ut1, _, st = ts.step(*args)
        assert bool(sj.converged) and st.converged
        assert abs(st.iters - int(sj.iters)) <= 1
        assert abs(st.lin_iters - int(sj.lin_iters)) <= st.iters
        assert _rel(ut1.numpy(), uj1) <= 1e-9
        for other in same:
            uo, _, so = other.step(*args)
            assert so.converged
            assert _rel(uo.numpy(), ut1.numpy()) <= 1e-9
        u_old, du = np.array(uj1), np.array(duj)


def _check_prep_applies(js, ts):
    """The JAX package's prepared tuple, carried over by
    `convert.prep_from_jax`, gives the JAX operator applies in the port
    (rel 1e-13); the port's own prep gives them at rel 1e-9."""
    jprep = js._exact_prep
    tprep = convert.prep_from_jax(jprep)
    ts._ensure_prepared()
    assert tprep.kind == ts._exact_prep.kind == jprep[0]
    jmv, jb, _ = js._prep_operators(jprep)
    x = np.random.default_rng(0).standard_normal(ts.disc.ndof)
    want_mv, want_b = np.asarray(jmv(jnp.asarray(x))), np.asarray(
        jb(jnp.asarray(x)))
    for prep, bar in ((tprep, 1e-13), (ts._exact_prep, 1e-9)):
        mv, b_prep, _ = ts._prep_operators(prep)
        assert _rel(mv(torch.as_tensor(x)).numpy(), want_mv) <= bar
        assert _rel(b_prep(torch.as_tensor(x)).numpy(), want_b) <= bar


def test_flagship_slice_matches_jax():
    """Stokes + 3 steps at the flagship structure ('auto' -> two-level +
    Chebyshev 3, plane layout, exact Jacobian, operator residual) in f64
    with Krylov rtol 1e-12: states at rel 1e-9, Newton and GMRES counts
    equal or within 1 per solve."""
    js, ts = _both_solvers(preconditioner="auto", spmv="plane")
    assert ts.cfg.krylov.preconditioner == js.cfg.krylov.preconditioner \
        == "two_level"
    assert ts.cfg.krylov.coarse_cheby == js.cfg.krylov.coarse_cheby == 3
    assert ts.cfg.krylov.coarse_agg == js.cfg.krylov.coarse_agg == 48
    assert ts.prep_kind == "tlp"
    _match_jax(js, ts)


def test_scalar_two_level_matches_jax_and_plane():
    """'tl': 'auto' on the scalar-DIA layout resolves to two-level +
    Chebyshev 3, as in the JAX package; Stokes + 3 steps match JAX at the
    flagship bars, and the port's own 'tlp' states at rel 1e-9."""
    js, ts = _both_solvers(preconditioner="auto", spmv="auto")
    assert ts.cfg.krylov.preconditioner == "two_level"
    assert ts.cfg.krylov.coarse_cheby == js.cfg.krylov.coarse_cheby == 3
    assert ts.prep_kind == "tl"
    plane = _port_solver(ts, spmv="plane")
    assert plane.prep_kind == "tlp"
    _match_jax(js, ts, same=(plane,))
    assert ts._res_A is ts._exact_prep.data      # the shared operator
    _check_prep_applies(js, ts)


@pytest.mark.parametrize("order,steps", [(2, 2), (0, 1)])
def test_block_jacobi_matches_jax(order, steps):
    """'bj' (S = D^{-1} A, Neumann boost of order 2 and 0): Stokes and
    `steps` steps at the flagship bars."""
    js, ts = _both_solvers(preconditioner="block_jacobi",
                           neumann_order=order)
    assert ts.prep_kind == "bj"
    _match_jax(js, ts, steps=steps)
    assert ts._exact_prep.s_offsets == ts.disc.dia_pattern.scaled_offsets
    _check_prep_applies(js, ts)


def test_multilevel_coarse_matches_jax():
    """'ml' (coarse_agg=4, coarse_dense_max=64: nc = 112 > 64, a dense
    second level of nc2 = 56) on the scalar layout against JAX, and on the
    plane layout against the scalar one."""
    js, ts = _both_solvers(preconditioner="two_level", coarse_agg=4,
                           coarse_dense_max=64)
    plane = _port_solver(ts, spmv="plane")
    ts._ensure_prepared()
    plane._ensure_prepared()
    for s in (ts, plane):
        assert isinstance(s._exact_prep.coarse, MultilevelCoarse)
        assert s._exact_prep.coarse.cs2.nc == 56
    assert js._exact_prep[6][0] == "ml"
    _match_jax(js, ts, steps=2, same=(plane,))
    _check_prep_applies(js, ts)


def test_golden_trajectory_flagship_mode():
    """The reference-derived 5-step trajectory (tests/data_golden_trajectory)
    in the flagship mode.  The Chebyshev smoother limits the match: the
    JAX package itself reaches 2.2e-8 here, so the bar is 1e-7."""
    golden = np.asarray(TRAJ)
    kr = SolverConfig(rtol=1e-13, atol=1e-14, maxiter=4000,
                      preconditioner="auto", spmv="plane")
    cfg = NSConfig(dt=1e-3, t_final=5e-3, reynolds=100.0, delta=0.1,
                   dtype="float64", krylov=kr, stokes_krylov=kr,
                   newton=NewtonConfig(rtol=1e-6, atol=1e-8, stol=1e-10,
                                       max_iter=30))
    s = NavierStokesSolver(channel_mesh(4, 2, 2), cfg, device=CPU)
    u = s.stokes_init()
    assert _rel(u.numpy(), golden[0]) < 1e-7
    u_old, du = u, torch.zeros_like(u)
    for step in range(1, 6):
        u, du, st = s.step(u, u_old, du)
        u_old = u
        assert st.converged
        err = _rel(u.numpy(), golden[step])
        assert err < 1e-7, f"step {step}: {err:.2e}"


def test_golden_trajectory_block_jacobi():
    """The golden 5-step trajectory on the 'bj' path (the float64
    default: block-Jacobi + Neumann 2, exact Jacobian), Krylov rtol 1e-13.
    The port is held to 10x the JAX package's own error on this config,
    and never looser than 1e-7."""
    golden = np.asarray(TRAJ)
    kr = JSolver(rtol=1e-13, atol=1e-14, maxiter=4000)
    jcfg = JNS(dt=1e-3, t_final=5e-3, reynolds=100.0, delta=0.1,
               dtype="float64", krylov=kr, stokes_krylov=kr,
               newton=JNewton(rtol=1e-6, atol=1e-8, stol=1e-10, max_iter=30))
    jmesh = j_channel(4, 2, 2)
    errs = {}
    for name, solver, to_np, wrap in (
            ("jax", JSolverModel(jmesh, jcfg), np.asarray, jnp.asarray),
            ("port", NavierStokesSolver(convert.mesh_from_jax(jmesh),
                                        convert.config_from_jax(jcfg),
                                        device=CPU),
             lambda u: u.numpy(), torch.as_tensor)):
        u = solver.stokes_init()
        e = [_rel(to_np(u), golden[0])]
        u_old, du = u, wrap(np.zeros(golden.shape[1]))
        for step in range(1, 6):
            u, du, st = solver.step(u, u_old, du)
            u_old = u
            assert bool(st.converged)
            e.append(_rel(to_np(u), golden[step]))
        errs[name] = max(e)
    bar = min(10 * errs["jax"], 1e-7)
    print(f"golden bj: JAX {errs['jax']:.3e}, port {errs['port']:.3e}, "
          f"bar {bar:.3e}")
    assert errs["port"] <= bar


def test_dat_writer_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.standard_normal(50), [0.0, -0.0, 1.0, -2.0,
                           2.5544, 1e-30, 123456789.0, np.inf, np.nan]])
    for arr in (vals, vals.astype(np.float32)):
        pj, pt = tmp_path / "j.dat", tmp_path / "t.dat"
        j_write(str(pj), jnp.asarray(arr))
        write_petsc_vec(str(pt), torch.as_tensor(arr))
        assert pt.read_bytes() == pj.read_bytes()
    back = read_petsc_vec(str(pt))
    assert back.shape == vals.shape
    np.testing.assert_allclose(back[:50], vals[:50], rtol=1e-5)


def test_cli_writes_dat_files(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "navierstokes_tpu_torch.run", "--nx", "4",
         "--ny", "2", "--nz", "2", "--steps", "2", "--save", "--save-dir",
         str(tmp_path / "res"), "--device", "cpu", "--dtype", "float32"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
    )
    assert out.returncode == 0, out.stderr
    assert "=== Time step 2" in out.stdout
    files = sorted(os.listdir(tmp_path / "res"))
    assert files == ["solution_step0001.dat", "solution_step0002.dat"]
    for f in files:
        text = (tmp_path / "res" / f).read_text()
        assert text.startswith(HEADER)
        assert len(read_petsc_vec(str(tmp_path / "res" / f))) == 4 * 45


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("kind", ["single", "distributed"])
def test_solver_turns_tf32_off(kind, monkeypatch):
    """TF32 would round the coarse GEMV's f32 operands to 10 mantissa bits
    (the card's counterpart of the TPU bf16 trap): the solver turns it off
    for its own work and only there.  A caller's two flags, set True, read
    False in every K1 call (the plain version, patched to look) of
    stokes_init, a step and a run, and are True again after each, and
    after building the solver (one device, and two shards)."""
    seen = []
    plain = tpd.spmv_planes_plain

    def looking(*args, **kwargs):
        seen.append(_tf32_flags())
        return plain(*args, **kwargs)

    monkeypatch.setattr(tpd, "spmv_planes_plain", looking)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg = NSConfig(dtype="float32", krylov=SolverConfig(**_PLANE),
                   stokes_krylov=SolverConfig(**_PLANE))
    mesh = channel_mesh(6, 2, 2)
    if kind == "single":
        solver = NavierStokesSolver(mesh, cfg, device=CPU)
    else:
        solver = DistributedNavierStokesSolver(mesh, cfg, devices=[CPU] * 2)
    assert _tf32_flags() == (True, True)
    u = solver.stokes_init()
    assert _tf32_flags() == (True, True)
    solver.step(u, u, torch.zeros_like(u))
    assert _tf32_flags() == (True, True)
    solver.run(1, u0=u, monitor=False)
    assert _tf32_flags() == (True, True)
    assert seen and set(seen) == {(False, False)}, seen


def test_tf32_off_restores_on_an_exception(monkeypatch):
    """`tf32_off` gives the caller's flags back when an exception leaves,
    and leaves flags that are off as they are."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    with pytest.raises(RuntimeError, match="inside"):
        with tf32_off():
            assert _tf32_flags() == (False, False)
            raise RuntimeError("inside")
    assert _tf32_flags() == (True, False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    with tf32_off():
        assert _tf32_flags() == (False, False)
    assert _tf32_flags() == (False, False)


@pytest.mark.parametrize("cfg_kw,krylov_kw,match", [
    ({}, dict(spmv="auto"), "spmv='plane'"),
    (dict(jacobian="reference"), dict(spmv="plane"), "jacobian='exact'"),
    ({}, dict(spmv="plane", schur_shape="upper"), "schur_shape"),
    ({}, dict(spmv="plane", deflation_k=4), "deflation_k"),
    ({}, dict(spmv="plane", coarse_agg=1, coarse_dense_max=64),
     "dense coarse"),
])
def test_solver_rejects_schur(cfg_kw, krylov_kw, match):
    """preconditioner='schur' runs (tests/test_torch_schur.py); what the
    JAX model refuses with it, the port refuses at resolution with the
    same ValueError: another layout than 'plane', another Jacobian than
    'exact', an unknown shape, deflation, and a velocity coarse space over
    coarse_dense_max (3 * 45 > 64 here)."""
    cfg = NSConfig(krylov=SolverConfig(preconditioner="schur", **krylov_kw),
                   **cfg_kw)
    with pytest.raises(ValueError, match=match):
        NavierStokesSolver(channel_mesh(4, 2, 2), cfg, device=CPU)


def test_auto_above_150k_rows_not_ported():
    """'auto' at nv = 40,000 (160k rows) resolves to the Schur tier, ported
    since slice 6: schur + schur_v_cheby=2, as in the JAX package; up to
    150k rows it stays two_level + coarse_cheby=3."""
    cfg = NSConfig(krylov=SolverConfig(preconditioner="auto", spmv="plane"))
    kr = resolve_supported(cfg, 40_000).krylov
    assert (kr.preconditioner, kr.schur_v_cheby, kr.schur_cheby,
            kr.coarse_agg) == ("schur", 2, 2, 128)
    jkr = j_resolve(JNS(krylov=JSolver(preconditioner="auto", spmv="plane")),
                    40_000).krylov
    assert dataclasses.asdict(jkr) == dataclasses.asdict(kr)
    low = resolve_supported(cfg, 37_500).krylov
    assert low.preconditioner == "two_level" and low.coarse_cheby == 3


def test_auto_schur_tier_with_pinned_coarse_cheby_raises():
    """A pinned coarse_cheby > 0 where 'auto' chooses the Schur tier raises
    one ValueError at resolution that names the knob and the tier; the same
    config below 150k rows runs two_level with the pinned degree."""
    cfg = NSConfig(krylov=SolverConfig(preconditioner="auto", spmv="plane",
                                       coarse_cheby=2))
    with pytest.raises(ValueError, match=r"coarse_cheby=2.*Schur tier|"
                                         r"Schur tier.*coarse_cheby=2"):
        resolve_supported(cfg, 40_000)
    assert resolve_supported(cfg, 37_500).krylov.coarse_cheby == 2


def test_auto_schur_tier_above_the_dense_cap_raises():
    """Above ~4.19M DoF 'auto' still chooses the Schur tier, but its dense
    velocity coarse inverse outgrows what 'auto' may raise
    coarse_dense_max to: one ValueError at resolution naming
    AUTO_COARSE_DENSE_CAP, not a failure deep in the prep.  Matrix 10's
    size (587,248 nodes) resolves."""
    cfg = NSConfig(krylov=SolverConfig(preconditioner="auto", spmv="plane"))
    with pytest.raises(ValueError, match="AUTO_COARSE_DENSE_CAP"):
        resolve_supported(cfg, 1_100_000)
    kr = resolve_supported(cfg, 587_248).krylov
    assert kr.preconditioner == "schur" and kr.coarse_agg == 256
    assert 3 * -(-587_248 // 256) <= kr.coarse_dense_max


@pytest.mark.parametrize("krylov_kw", [
    dict(preconditioner="ilu0", spmv="plane"),
    dict(preconditioner="none", spmv="plane"),
])
def test_options_outside_the_slice_raise(krylov_kw):
    """'ilu0' and 'none' are the two options the port does not run: the
    JAX package runs block-Jacobi under both names (its ILU(0) is a host
    oracle, `solvers/precond.py`), so the port raises a ValueError that
    says so (tests/test_torch_krylov_variants.py has every other)."""
    cfg = NSConfig(krylov=SolverConfig(**krylov_kw))
    with pytest.raises(ValueError, match="runs block-Jacobi under this name"):
        resolve_supported(cfg, 1000)


@pytest.mark.parametrize("cfg_kw,krylov_kw,kind", [
    ({}, dict(preconditioner="block_jacobi", spmv="plane"), "bj"),
    ({}, dict(preconditioner="two_level", spmv="auto"), "tl"),
    ({}, dict(_PLANE, coarse_agg=4, coarse_dense_max=64), "tlp"),
    ({}, dict(preconditioner="two_level", spmv="auto", cgs2="pallas_comp"),
     "tl"),
    ({}, dict(_PLANE, cgs2="pallas"), "tlp"),
    ({}, dict(preconditioner="schur", spmv="plane", schur_v_cheby=2),
     "sch"),
    ({}, dict(preconditioner="block_jacobi", matvec_dtype="bfloat16"), "bj"),
    ({}, dict(preconditioner="two_level", spmv="pallas",
              matvec_dtype="bfloat16"), "tl"),
    ({}, dict(_PLANE, method="ca_gmres"), "tlp"),
    ({}, dict(_PLANE, method="cg"), "tlp"),
    ({}, dict(_PLANE, deflation_k=8), "tlp"),
    ({}, dict(_PLANE, coarse_basis="linear"), "tlp"),
    ({}, dict(_PLANE, coarse_smooth_omega=0.5), "tlp"),
    ({}, dict(preconditioner="two_level", spmv="auto",
              coarse_smooth_omega=0.5), "tl"),
    (dict(jacobian="reference"), _PLANE, "tlp"),
    (dict(residual="elementwise"), _PLANE, "tlp"),
])
def test_options_now_in_the_slice_run(cfg_kw, krylov_kw, kind):
    """Options the scalar-DIA slice, the fused-CGS2 slice, the Schur tier,
    matvec_dtype, and then CA-GMRES, CG, deflation, the coarse variants,
    the reference Jacobian and the element-wise residual brought in: each
    resolves and takes a CPU Stokes solve on channel(6,3,3) (nv = 112, so
    the third case has nc = 112 > 64 and takes the multilevel coarse
    level; the cgs2 cases orthogonalize through K3's plain version; the
    matvec_dtype cases apply a bf16 operator), converged but for CG: CG
    is for SPD sub-problems, and on the indefinite Stokes operator it
    breaks down unconverged, as in the JAX package.  The Newton operator
    is then prepared: deflated with deflation_k, per Newton iteration in
    reference mode."""
    kr = SolverConfig(rtol=1e-10, atol=1e-12, **krylov_kw)
    cfg = NSConfig(dtype="float64", krylov=kr, stokes_krylov=kr, **cfg_kw)
    s = NavierStokesSolver(channel_mesh(6, 3, 3, obstacle=True), cfg,
                           device=CPU)
    assert s.prep_kind == kind
    tcgs2.reset_counters()
    u = s.stokes_init()
    if krylov_kw.get("method") == "cg":
        assert s.stokes_result.iters > 0 and not s.stokes_result.converged
    else:
        assert s.stokes_result.converged and bool(torch.isfinite(u).all())
    assert (tcgs2.plain_calls > 0) == ("cgs2" in krylov_kw)
    if "coarse_dense_max" in krylov_kw:
        assert isinstance(s._prepare_operator_dia(s._stokes_dia()).coarse,
                          MultilevelCoarse)
    s._ensure_prepared()
    prep = s._exact_prep
    if "matvec_dtype" in krylov_kw:
        data = prep.s_data if kind == "bj" else prep.data
        assert data.dtype == torch.bfloat16
        assert prep.invd.dtype == s._res_A.dtype == torch.float64
    assert (prep is None) == (cfg.jacobian == "reference")
    assert (prep is not None and prep.kind == "defl") == \
        ("deflation_k" in krylov_kw)


@pytest.mark.parametrize("krylov_kw,nv,kind", [
    (_PLANE, 1000, "tlp"),
    (dict(preconditioner="auto", spmv="plane"), 1000, "tlp"),
    (dict(preconditioner="auto", spmv="plane"), 40_000, "sch"),
    (dict(preconditioner="schur", spmv="plane"), 1000, "sch"),
])
def test_matvec_dtype_outside_the_scalar_layouts_raises(krylov_kw, nv,
                                                        kind):
    """The JAX package casts to matvec_dtype on 'tl' and 'bj' only; its
    'tlp' and 'sch' preps ignore the option, and so does 'auto', which
    resolves to one of them at every size.  The port raises one ValueError
    after resolution that names the layouts that take it."""
    cfg = NSConfig(krylov=SolverConfig(matvec_dtype="bfloat16", **krylov_kw))
    with pytest.raises(ValueError, match=rf"scalar-DIA layouts.*'{kind}'"):
        resolve_supported(cfg, nv)
    bad = NSConfig(krylov=SolverConfig(preconditioner="block_jacobi",
                                       matvec_dtype="float16"))
    with pytest.raises(ValueError, match="unknown matvec_dtype"):
        resolve_supported(bad, nv)


@pytest.mark.parametrize("krylov_kw", [
    dict(preconditioner="block_jacobi"),
    dict(preconditioner="two_level", spmv="auto", coarse_cheby=3),
])
def test_matvec_dtype_matches_jax(krylov_kw):
    """matvec_dtype='bfloat16' on 'bj' (S in bf16) and 'tl' (A in bf16,
    D^{-1} and the coarse level from the full-precision operator, the
    Chebyshev interval from the cast one) with the f64 run dtype: Stokes
    and one step equal the JAX package's at rel 1e-9, the carried-over
    prep gives its applies at rel 1e-13, and Newton's residual uses the
    full-precision operator (not the shared bf16 one)."""
    js, ts = _both_solvers(matvec_dtype="bfloat16", **krylov_kw)
    _match_jax(js, ts, steps=1)
    _check_prep_applies(js, ts)
    assert ts._res_A.dtype == torch.float64


def test_matvec_dtype_block_jacobi_drifts_as_in_jax():
    """Where the bf16 operator fails on 'bj', it fails in the JAX package
    alike: at matrix 3 (5,832 rows) in f32 with the JAX test's tolerances
    (Neumann order 2), one step from the full-precision Stokes state stalls
    (Newton's f32 stagnation exit) with the same Newton and GMRES counts in
    both packages, states at rel 1e-3, both far from the full-precision
    step."""
    from navierstokes_tpu.mesh.box import scaling_series_mesh as j_series

    jmesh = j_series(3)
    kr = JSolver(rtol=1e-4, atol=1e-5, maxiter=3000, neumann_order=2,
                 preconditioner="block_jacobi")
    jcfg = JNS(dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
               krylov=kr, stokes_krylov=kr,
               newton=JNewton(rtol=1e-3, atol=1e-4, du_tol=float("inf")))
    j16 = dataclasses.replace(jcfg, krylov=dataclasses.replace(
        kr, matvec_dtype="bfloat16"))
    mesh = convert.mesh_from_jax(jmesh)
    full = NavierStokesSolver(mesh, convert.config_from_jax(jcfg),
                              device=CPU)
    ts = NavierStokesSolver(mesh, convert.config_from_jax(j16),
                            disc=full.disc, device=CPU)
    u0 = full.stokes_init()
    zero = torch.zeros_like(u0)
    u32, _, st32 = full.step(u0, u0, zero)
    ut, _, st = ts.step(u0, u0, zero)
    uj, _, sj = JSolverModel(jmesh, j16).step(
        *(jnp.asarray(u0.numpy()),) * 2, jnp.zeros(u0.shape, jnp.float32))
    assert st32.converged and st32.iters == 2
    assert not st.converged and not bool(sj.converged)
    assert st.iters == int(sj.iters) >= 4
    assert abs(st.lin_iters - int(sj.lin_iters)) <= st.iters
    assert _rel(ut.numpy(), uj) <= 1e-3
    assert _rel(ut.numpy(), u32.numpy()) > 1.0
    assert _rel(np.asarray(uj), u32.numpy()) > 1.0


def test_bf16_matvec_mode():
    """The f32 mirror of the JAX package's `test_bf16_matvec_mode` (its
    mesh, configs and bars): bf16 operator storage on 'bj' converges at
    loose tolerances and lands within 5e-2 of the full-precision
    solution; the same on 'tl'."""
    mesh = channel_mesh(3, 2, 2, length=2.0)
    kr = SolverConfig(rtol=1e-4, atol=1e-5, maxiter=3000, neumann_order=1)
    cfg32 = NSConfig(dt=0.01, t_final=0.03, reynolds=100.0, delta=0.1,
                     dtype="float32", krylov=kr, stokes_krylov=kr,
                     newton=NewtonConfig(rtol=1e-3, atol=1e-4,
                                         du_tol=float("inf")))
    for extra in ({}, dict(preconditioner="two_level", spmv="auto",
                           coarse_agg=4)):
        kr32 = dataclasses.replace(kr, **extra)
        kr16 = dataclasses.replace(kr32, matvec_dtype="bfloat16")
        s32 = NavierStokesSolver(mesh, dataclasses.replace(
            cfg32, krylov=kr32, stokes_krylov=kr32), device=CPU)
        s16 = NavierStokesSolver(mesh, dataclasses.replace(
            cfg32, krylov=kr16, stokes_krylov=kr16), device=CPU)
        u0 = s32.stokes_init()
        u32, _, st32 = s32.step(u0, u0, torch.zeros_like(u0))
        u16, _, st16 = s16.step(u0, u0, torch.zeros_like(u0))
        assert st32.converged and st16.converged
        assert u16.dtype == torch.float32
        rel = _rel(u16.numpy(), u32.numpy())
        assert rel < 5e-2, f"bf16 solution drift {rel} ({s16.prep_kind})"


def test_stokes_krylov_only_sets_the_solve():
    """As in the JAX package, both operators are prepared from cfg.krylov;
    the default stokes_krylov (block_jacobi) is therefore accepted."""
    cfg = NSConfig(krylov=SolverConfig(**_PLANE))
    assert resolve_supported(cfg, 1000).stokes_krylov.preconditioner == \
        "block_jacobi"
    bad = dataclasses.replace(cfg,
                              stokes_krylov=SolverConfig(method="bicgstab"))
    with pytest.raises(ValueError, match="unknown method"):
        resolve_supported(bad, 1000)


@pytest.mark.parametrize("argv,cards", [
    (["--nx", "2", "--devices", "2"], 1),
])
def test_cli_flags_outside_the_slice_raise(argv, cards, monkeypatch):
    """Every flag of the JAX CLI is accepted and runs (`--devices` since
    slice 15: tests/test_torch_distributed.py; `--cpu` and the Schur flags:
    test_cli_schur_flags_run; the I/O flags: test_cli_io_flags_run; the
    solver-option flags: test_cli_option_flags_run).  The one refusal left
    is deliberate: `--devices N` on the card raises where fewer than N
    cards exist (the JAX CLI takes the devices there are); the count is
    faked here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(ValueError, match="--devices 2: 1 CUDA device"):
        run.main(argv + ["--device", "cuda"])


@pytest.mark.parametrize("argv,want", [
    (["--deflation-k", "8", "--preconditioner", "two_level", "--spmv",
      "plane", "--coarse-agg", "4"], dict(deflation_k=8)),
    (["--deflation-k", "6", "--deflation-arnoldi", "40", "--preconditioner",
      "two_level", "--coarse-agg", "4"],
     dict(deflation_k=6, deflation_arnoldi=40)),
    (["--ca-gmres"], dict(method="ca_gmres", ca_basis="monomial")),
    (["--ca-gmres", "--ca-basis", "newton", "--restart", "12",
      "--preconditioner", "two_level", "--coarse-agg", "4"],
     dict(method="ca_gmres", ca_basis="newton", restart=12)),
    (["--preconditioner", "two_level", "--spmv", "plane", "--coarse-basis",
      "linear", "--coarse-agg", "4"], dict(coarse_basis="linear")),
    (["--preconditioner", "two_level", "--coarse-agg", "4",
      "--coarse-smooth-omega", "0.5"], dict(coarse_smooth_omega=0.5)),
], ids=["deflation-k", "deflation-arnoldi", "ca-gmres", "ca-basis",
        "coarse-basis", "coarse-smooth-omega"])
def test_cli_option_flags_run(argv, want):
    """The JAX CLI's flags of the deflation, CA-GMRES and coarse-variant
    slices run (f64 on channel(3,2,2), Stokes + 1 step), with the flags that
    make each take effect; each reaches both solver configs."""
    out = run.main(["--nx", "3", "--ny", "2", "--nz", "2", "--steps", "1",
                    "--device", "cpu"] + argv)
    s = out.solver
    for sc in (s.cfg.krylov, s.cfg.stokes_krylov):
        assert {k: getattr(sc, k) for k in want} == want
    assert s.history[0][1].converged
    if "deflation_k" in want:
        assert s._exact_prep.kind == "defl"
    if want.get("ca_basis") == "newton":
        assert len(s._ca_shifts) == 12
    if "coarse_basis" in want:
        assert s._exact_prep.coarse.w.shape[0] == 4


_SMALL = ["--nx", "3", "--ny", "2", "--nz", "2", "--device", "cpu"]


@pytest.mark.parametrize("flag", ["--msh", "--vtu", "--checkpoint",
                                  "--resume", "--checkpoint-every",
                                  "--profile"])
def test_cli_io_flags_run(flag, tmp_path, capsys):
    """The JAX CLI's I/O flags run (f64 'bj' on channel(3,2,2)): a Gmsh
    mesh in, `.vtu` files and a `.pvd` out, a checkpoint every N steps, a
    resume that repeats the uninterrupted run, the event table."""
    res, ck = str(tmp_path / "res"), str(tmp_path / "ck.npz")
    if flag == "--msh":
        msh = str(tmp_path / "mesh.msh")
        write_gmsh(channel_mesh(3, 2, 2), msh)
        out = run.main(["--msh", msh, "--steps", "1", "--device", "cpu"])
        assert out.solver.disc.nv == channel_mesh(3, 2, 2).nv
    elif flag == "--vtu":
        out = run.main(_SMALL + ["--steps", "2", "--save", "--save-dir", res,
                                 "--vtu"])
        assert sorted(os.listdir(res)) == [
            "solution_0001.vtu", "solution_0002.vtu",
            "solution_step0001.dat", "solution_step0002.dat",
            "time_series.pvd"]
        assert 'file="solution_0002.vtu"' in open(
            os.path.join(res, "time_series.pvd")).read()
    elif flag in ("--checkpoint", "--checkpoint-every"):
        out = run.main(_SMALL + ["--steps", "3", "--checkpoint", ck,
                                 "--checkpoint-every", "2"])
        step, u, u_old, _ = load_checkpoint(ck, cfg=out.solver.user_cfg)
        assert step == 2 and np.array_equal(u, u_old)
    elif flag == "--resume":
        run.main(_SMALL + ["--steps", "1", "--checkpoint", ck,
                           "--checkpoint-every", "1"])
        out = run.main(_SMALL + ["--steps", "3", "--resume", ck])
        assert [h[0] for h in out.solver.history] == [2, 3]
        assert out.solver.stokes_result is None
        whole = run.main(_SMALL + ["--steps", "3"])
        assert _rel(out.u.numpy(), whole.u.numpy()) <= 1e-13
    else:
        out = run.main(_SMALL + ["--steps", "1", "--profile"])
        table = capsys.readouterr().out
        assert "Event" in table and "GFLOP/s" in table
        for event in ("setup", "stokes_init", "operator_prep", "time_loop"):
            assert event in table
    assert all(st.converged for _, st, _ in out.solver.history)


@pytest.mark.parametrize("shape", ["lower", "full"])
def test_cli_schur_flags_run(shape):
    """The Schur tier's flags reach both solver configs and run (f32, 'sch'
    on channel(3,2,2)); `--cpu` is `--device cpu`."""
    out = run.main(["--nx", "3", "--ny", "2", "--nz", "2", "--steps", "1",
                    "--cpu", "--dtype", "float32", "--preconditioner",
                    "schur", "--coarse-agg", "4", "--schur-cheby", "3",
                    "--schur-v-cheby", "2", "--schur-shape", shape])
    s = out.solver
    assert s.device == CPU and s.prep_kind == "sch"
    for sc in (s.cfg.krylov, s.cfg.stokes_krylov):
        assert (sc.schur_cheby, sc.schur_v_cheby, sc.schur_shape) == \
            (3, 2, shape)
    assert s._exact_prep.cheby_s[2] == 3 and s._exact_prep.cheby_v[2] == 2
    assert s.stokes_result.converged and s.history[0][1].converged


def test_cli_cgs2_runs():
    """`--cgs2` runs on every prep: here the f64 default ('bj') on
    channel(4,2,2) with compensated sums, every GMRES iteration through
    K3's plain version."""
    tcgs2.reset_counters()
    out = run.main(["--nx", "4", "--ny", "2", "--nz", "2", "--steps", "1",
                    "--cgs2", "pallas_comp", "--device", "cpu"])
    s = out.solver
    assert s.cfg.krylov.cgs2 == s.cfg.stokes_krylov.cgs2 == "pallas_comp"
    assert s.stokes_result.converged and s.history[0][1].converged
    assert tcgs2.plain_calls > 0 and tcgs2.kernel_launches == 0


def test_unknown_cgs2_raises():
    cfg = NSConfig(krylov=SolverConfig(**_PLANE, cgs2="mgs"))
    with pytest.raises(ValueError, match="cgs2"):
        resolve_supported(cfg, 1000)


@pytest.mark.parametrize("extra", [[], ["--spmv", "pallas"],
                                   ["--preconditioner", "block_jacobi"]])
def test_cli_cpu_default_is_float64_block_jacobi(extra):
    """As the JAX CLI on a CPU backend: --device cpu without --dtype runs
    float64 with SolverConfig() (block-Jacobi + Neumann 2); every scalar
    SpMV goes through K2's plain version."""
    tdia.reset_counters()
    out = run.main(["--nx", "4", "--ny", "2", "--nz", "2", "--steps", "2",
                    "--device", "cpu", *extra])
    s = out.solver
    assert s.cfg.dtype == "float64" and out.u.dtype == torch.float64
    assert s.prep_kind == "bj" and s.cfg.krylov.neumann_order == 2
    assert s.stokes_result.converged
    assert all(st.converged for _, st, _ in s.history)
    assert tdia.plain_calls > 0 and tdia.kernel_launches == 0


def test_cli_krylov_flags_reach_both_solvers():
    out = run.main(["--nx", "4", "--ny", "2", "--nz", "2", "--steps", "0",
                    "--device", "cpu", "--preconditioner", "two_level",
                    "--spmv", "xla", "--coarse-agg", "2", "--coarse-cheby",
                    "2", "--coarse-cheby-fraction", "0.25", "--restart",
                    "20", "--neumann-order", "1", "--coarse-ml-smooth", "2",
                    "--coarse-ml-cycles", "3", "--coarse-ml-damp", "0.5"])
    want = dict(preconditioner="two_level", spmv="xla", coarse_agg=2,
                coarse_cheby=2, coarse_cheby_fraction=0.25, restart=20,
                neumann_order=1, coarse_ml_smooth=2, coarse_ml_cycles=3,
                coarse_ml_damp=0.5)
    cfg = out.solver.cfg
    for sc in (cfg.krylov, cfg.stokes_krylov):
        assert {k: getattr(sc, k) for k in want} == want
    assert out.solver.prep_kind == "tl"
    assert out.solver.stokes_result.converged


def test_import_leaves_jax_out():
    code = ("import sys, navierstokes_tpu_torch, navierstokes_tpu_torch.run\n"
            "import navierstokes_tpu_torch.model, navierstokes_tpu_torch.convert\n"
            "import navierstokes_tpu_torch.bench.transient_bench\n"
            "import navierstokes_tpu_torch.bench.gmres_decomp\n"
            "import navierstokes_tpu_torch.bench.spmv_bench\n"
            "import navierstokes_tpu_torch.io, navierstokes_tpu_torch.utils\n"
            "import navierstokes_tpu_torch.mesh.gmsh\n"
            "import navierstokes_tpu_torch.mesh.ordering\n"
            "import navierstokes_tpu_torch.solvers.precond\n"
            "import navierstokes_tpu_torch.solvers.sstep\n"
            "import navierstokes_tpu_torch.solvers.cg\n"
            "import navierstokes_tpu_torch.solvers.deflation\n"
            "import navierstokes_tpu_torch.sparse.bcsr\n"
            "import navierstokes_tpu_torch.parallel.dryrun\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'navierstokes_tpu.')) or m == 'navierstokes_tpu']\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
