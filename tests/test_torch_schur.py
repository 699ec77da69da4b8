"""The port's pressure-Schur tier ('sch': `navierstokes_tpu_torch/solvers/
schur.py` and the model's Schur prep) against the JAX package's.

The host algebra must equal the JAX package's on the same operator (and
S_hat the dense A_pp - A_pu diag(F)^{-1} A_up); the prepared applies must
equal JAX's, carried over by `convert.prep_from_jax` and built by the port
itself; Stokes and two steps must reach JAX's states; the golden
trajectory must hold with the tier forced.  The JAX side runs on the CPU as
its own tests do (Pallas in interpret mode).  f64 throughout, tiny meshes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.config import NSConfig as JNS
from navierstokes_tpu.config import SolverConfig as JSolver
from navierstokes_tpu.mesh import channel_mesh as j_channel
from navierstokes_tpu.model import NavierStokesSolver as JSolverModel
from navierstokes_tpu.ops.plane_dia import node_offsets_from_scalar
from navierstokes_tpu.solvers import schur as jsch
from navierstokes_tpu.solvers.coarse import build_aggregates as j_aggregates
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.bench import gmres_decomp, transient_bench
from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu_torch.mesh import channel_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.model.navier_stokes import SchurPrep
from navierstokes_tpu_torch.ops import plane_dia as tpd
from navierstokes_tpu_torch.ops.plane_dia import from_planes, to_planes
from navierstokes_tpu_torch.solvers import schur as tsch
from navierstokes_tpu_torch.solvers.coarse import build_aggregates

from data_golden_trajectory import TRAJ
from test_torch_model import _match_jax

torch.set_num_threads(1)
CPU = torch.device("cpu")
KRYLOV = JSolver(rtol=1e-12, atol=1e-13, maxiter=4000,
                 preconditioner="two_level", coarse_agg=4)
CFG = JNS(dt=0.01, t_final=0.03, reynolds=100.0, delta=0.1,
          dtype="float64", krylov=KRYLOV,
          stokes_krylov=dataclasses.replace(KRYLOV, rtol=1e-13))
SCHUR_KNOBS = [
    {"schur_cheby": 0},
    {"schur_cheby": 2},
    {"schur_cheby": 2, "schur_v_cheby": 2},
    {"schur_cheby": 2, "schur_shape": "full"},
]


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))


@pytest.fixture(scope="module")
def jax_problem():
    """The JAX solver on channel(3,2,2) of length 2 (coarse_agg 4), its
    BC-applied exact Jacobian and the block view of it."""
    js = JSolverModel(j_channel(3, 2, 2, length=2.0), CFG)
    js._ensure_prepared()
    offsets = js.disc.dia_pattern.offsets
    dd = np.asarray(js._jlin_bc_dia)
    nb = js.disc.mesh.nv
    noffs = node_offsets_from_scalar(offsets)
    return js, offsets, dd, nb, noffs


def _schur_cfg(cfg, **knobs):
    kr = dataclasses.replace(cfg.krylov, preconditioner="schur", spmv="plane",
                             **knobs)
    return dataclasses.replace(
        cfg, krylov=kr, stokes_krylov=dataclasses.replace(kr, rtol=1e-13))


def _dia_to_dense(offsets, data, n):
    a = np.zeros((n, n))
    for k, d in enumerate(offsets):
        lo, hi = max(0, -d), n - max(0, d)
        rows = np.arange(lo, hi)
        a[rows, rows + d] = data[k, lo:hi]
    return a


def test_schur_algebra_matches_jax(jax_problem):
    """Block view, diag(F)^{-1}, S_hat, both coarse inverses and both
    power-iteration lmax equal the JAX package's functions on the same
    operator (rel <= 1e-14; the same operations in the same order), and
    S_hat equals the dense A_pp - A_pu diag(F)^{-1} A_up (rel <= 1e-12)."""
    _, offsets, dd, nb, noffs = jax_problem
    a_blk = tsch.split_blocks(offsets, dd, nb, noffs)
    j_blk = jsch.split_blocks(offsets, dd, nb, noffs)
    assert np.array_equal(a_blk, j_blk)
    fd_inv = tsch.diag_f_inverse(a_blk, noffs)
    assert _rel(fd_inv, jsch.diag_f_inverse(j_blk, noffs)) <= 1e-14
    s_offs, s_np = tsch.build_schur_dia(a_blk, noffs, nb, fd_inv)
    js_offs, js_np = jsch.build_schur_dia(j_blk, noffs, nb, fd_inv)
    assert s_offs == js_offs and len(s_offs) == 53
    assert _rel(s_np, js_np) <= 1e-14

    cs, jcs = build_aggregates(nb, 4), j_aggregates(nb, 4)
    for shift in (0.0, 1e-6):
        assert _rel(tsch.velocity_coarse_inverse(cs, a_blk, noffs,
                                                 shift=shift),
                    jsch.velocity_coarse_inverse(jcs, j_blk, noffs,
                                                 shift=shift)) <= 1e-14
        assert _rel(tsch.scalar_coarse_inverse(cs, s_offs, s_np, shift=shift),
                    jsch.scalar_coarse_inverse(jcs, js_offs, js_np,
                                               shift=shift)) <= 1e-14
    sdinv = 1.0 / s_np[s_offs.index(0)]
    lam_s = tsch.power_lmax_schur(s_offs, s_np, sdinv)
    lam_v = tsch.power_lmax_velocity(a_blk, noffs, fd_inv)
    assert abs(lam_s - jsch.power_lmax_schur(js_offs, js_np, sdinv)) \
        <= 1e-14 * lam_s
    assert abs(lam_v - jsch.power_lmax_velocity(j_blk, noffs, fd_inv)) \
        <= 1e-14 * lam_v

    a = _dia_to_dense(offsets, dd, 4 * nb)
    iu = np.sort(np.concatenate([4 * np.arange(nb) + c for c in range(3)]))
    ip = 4 * np.arange(nb) + 3
    fd_full = np.zeros((3 * nb, 3 * nb))
    for i in range(nb):
        fd_full[3 * i:3 * i + 3, 3 * i:3 * i + 3] = fd_inv[i]
    s_ref = a[np.ix_(ip, ip)] - a[np.ix_(ip, iu)] @ fd_full \
        @ a[np.ix_(iu, ip)]
    s_dense = _dia_to_dense(s_offs, s_np, nb)
    assert np.abs(s_dense - s_ref).max() / np.abs(s_ref).max() <= 1e-12


@pytest.mark.parametrize("n_comp", [1, 3])
def test_plane_transfers_match_jax(n_comp):
    """restrict_planes_n / prolong_planes_n on plane-major vectors equal
    the JAX package's, padding rows of the prolongation exactly zero."""
    nb, agg = 45, 4
    cs, jcs = build_aggregates(nb, agg), j_aggregates(nb, agg)
    nbp = tpd.plane_nbp(nb, cs.nb_pad)
    rng = np.random.default_rng(7 + n_comp)
    r = np.zeros((n_comp, nbp))
    r[:, :nb] = rng.standard_normal((n_comp, nb))
    rc = tsch.restrict_planes_n(cs, torch.as_tensor(r.reshape(-1)), nbp,
                                n_comp).numpy()
    assert _rel(rc, jsch.restrict_planes_n(jcs, jnp.asarray(r.reshape(-1)),
                                           nbp, n_comp)) <= 1e-15
    zc = rng.standard_normal(n_comp * cs.n_agg)
    z = tsch.prolong_planes_n(cs, torch.as_tensor(zc), nbp, nb,
                              n_comp).numpy()
    assert np.array_equal(z, np.asarray(jsch.prolong_planes_n(
        jcs, jnp.asarray(zc), nbp, nb, n_comp)))
    assert not z.reshape(n_comp, nbp)[:, nb:].any()


@pytest.mark.parametrize("knobs", SCHUR_KNOBS,
                         ids=["jacobi", "cheby_s", "cheby_sv", "full"])
def test_prep_applies_match_jax(jax_problem, knobs):
    """The JAX 'sch' prep carried over by `convert.prep_from_jax` gives the
    JAX package's matvec and minv in the port at rel 1e-13; the port's own
    prep gives them at rel 1e-9 (its own nbp, its own host algebra)."""
    js0 = jax_problem[0]
    cfg = _schur_cfg(CFG, **knobs)
    js = JSolverModel(js0.disc.mesh, cfg, disc=js0.disc)
    jprep = js._exact_prep
    assert jprep[0] == "sch"
    ts = NavierStokesSolver(convert.mesh_from_jax(js0.disc.mesh),
                            convert.config_from_jax(cfg), device=CPU)
    assert ts.prep_kind == "sch"
    ts._ensure_prepared()
    own = ts._exact_prep
    carried = convert.prep_from_jax(jprep)
    assert isinstance(own, SchurPrep) and isinstance(carried, SchurPrep)
    assert own.s_offsets == carried.s_offsets
    assert own.cheby_s == carried.cheby_s and own.cheby_v == carried.cheby_v
    assert (own.p_g is None) == (knobs.get("schur_shape") != "full")
    assert ts._res_A is own.p4                   # the shared operator

    nb, jnbp = ts.disc.nv, jprep[6]
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(4 * nb))
    jmv, jb, jparts = js._prep_operators(jprep)
    jx = jnp.asarray(to_planes(x, nb, jnbp).numpy())
    want = [from_planes(torch.as_tensor(np.array(f(jx))), nb, jnbp).numpy()
            for f in (jmv, jb)]
    for prep, bar in ((carried, 1e-13), (own, 1e-9)):
        mv, b_prep, parts = ts._prep_operators(prep)
        assert set(parts) == set(jparts)
        xp = to_planes(x, nb, prep.nbp)
        for f, w in zip((mv, b_prep), want):
            assert _rel(from_planes(f(xp), nb, prep.nbp).numpy(), w) <= bar


def test_schur_slice_matches_jax(jax_problem):
    """Stokes + 2 steps with preconditioner='schur' (the 'auto' tier's
    knobs: Chebyshev 2 on both smoothers) in both packages from the same
    states: states at rel 1e-9, Newton and GMRES counts within 1."""
    js0 = jax_problem[0]
    cfg = _schur_cfg(CFG, schur_v_cheby=2)
    js = JSolverModel(js0.disc.mesh, cfg, disc=js0.disc)
    ts = NavierStokesSolver(convert.mesh_from_jax(js0.disc.mesh),
                            convert.config_from_jax(cfg), device=CPU)
    tpd.reset_counters()
    _match_jax(js, ts, steps=2)
    assert tpd.plain_calls > 0 and tpd.kernel_launches == 0


def test_golden_trajectory_schur():
    """The reference-derived 5-step trajectory with the Schur tier forced
    (its 'auto' knobs), f64, Krylov rtol 1e-13: rel <= 1e-7, the flagship
    bar."""
    golden = np.asarray(TRAJ)
    kr = SolverConfig(rtol=1e-13, atol=1e-14, maxiter=4000,
                      preconditioner="schur", spmv="plane", schur_v_cheby=2)
    cfg = NSConfig(dt=1e-3, t_final=5e-3, reynolds=100.0, delta=0.1,
                   dtype="float64", krylov=kr, stokes_krylov=kr,
                   newton=NewtonConfig(rtol=1e-6, atol=1e-8, stol=1e-10,
                                       max_iter=30))
    s = NavierStokesSolver(channel_mesh(4, 2, 2), cfg, device=CPU)
    assert s.prep_kind == "sch"
    u = s.stokes_init()
    errs = [_rel(u.numpy(), golden[0])]
    u_old, du = u, torch.zeros_like(u)
    for step in range(1, 6):
        u, du, st = s.step(u, u_old, du)
        u_old = u
        assert st.converged
        errs.append(_rel(u.numpy(), golden[step]))
    assert max(errs) < 1e-7, errs


def _sumset_offsets():
    """The 65 node offsets of S_hat on a channel mesh of 4 x 4 x 4 cells."""
    L, P = 5, 25
    base = (1, L, L + 1, P, P + 1, P + L, P + L + 1)
    node = sorted({0, *base, *(-b for b in base)})
    offs = tuple(sorted({a + b for a in node for b in node}))
    assert len(node) == 15 and len(offs) == 65
    return offs


def test_plain_takes_the_schur_band():
    """K1's plain version on a 1x1 operator with S_hat's 65 node offsets,
    random data nonzero also where i + D leaves the matrix, equals the
    dense product (rel 1e-14); 128 offsets are taken."""
    offs = _sumset_offsets()
    nb, nbp = 300, tpd.plane_nbp(300)
    rng = np.random.default_rng(65)
    data = np.zeros((1, len(offs), nbp))
    data[0, :, :nb] = rng.standard_normal((len(offs), nb))
    x = np.zeros(nbp)
    x[:nb] = rng.standard_normal(nb)
    dense = np.zeros((nb, nb))
    for k, d in enumerate(offs):
        rows = np.arange(max(0, -d), nb - max(0, d))
        dense[rows, rows + d] = data[0, k, rows]
    y = tpd.spmv_planes(offs, torch.as_tensor(data), torch.as_tensor(x),
                        n_in=1, nb=nb).numpy()
    assert _rel(y[:nb], dense @ x[:nb]) <= 1e-14
    assert not y[nb:].any()
    wide = tuple(range(-64, 64))
    y = tpd.spmv_planes(wide, torch.ones(1, 128, nbp, dtype=torch.float64),
                        torch.ones(nbp, dtype=torch.float64), n_in=1, nb=nb)
    assert float(y[200]) == 128.0


@pytest.mark.cuda
def test_kernel_takes_the_schur_band_on_the_card():
    """K1, both routes, on the 65-offset 1x1 form: within the bar of the
    plain version and equal bit for bit between routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU or interpret mode")
    offs = _sumset_offsets()
    nb = 29_000
    nbp = tpd.plane_nbp(nb)
    rng = np.random.default_rng(66)
    for dtype, bar in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        data = torch.as_tensor(rng.standard_normal((1, len(offs), nbp)),
                               dtype=dtype).cuda()
        x = torch.as_tensor(rng.standard_normal(nbp), dtype=dtype).cuda()
        ref = tpd.spmv_planes_plain(offs, data, x, n_in=1, nb=nb)
        ys = [tpd.spmv_planes_cuda(offs, data, x, n_in=1, nb=nb, route=r)
              for r in tpd.ROUTES]
        torch.cuda.synchronize()
        assert torch.equal(ys[0], ys[1])
        assert float(torch.linalg.norm(ys[0] - ref)
                     / torch.linalg.norm(ref)) <= bar


def test_transient_bench_prints_its_line(capsys, tmp_path):
    """transient_bench at matrix 1 on the CPU, the product default and the
    Schur tier forced: one TRANSIENT line per run with finite numbers; with
    `--disc-cache`, a run that builds and saves the discretization and one
    that loads it give the same counts and the same state bit for bit."""
    res = transient_bench.main(["--matrix-id", "1", "--device", "cpu",
                                "--steps", "2", "--sweep",
                                "preconditioner=auto;preconditioner=schur,"
                                "coarse_agg=4,schur_v_cheby=2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("TRANSIENT")]
    assert len(lines) == len(res) == 2
    assert "prep=tlp" in lines[0] and "prep=sch" in lines[1]
    for r in res:
        assert r["ndof"] == 252 and r["lin"] > 0
        assert all(np.isfinite(r[k]) for k in ("setup_s", "stokes_s",
                                               "compile_s", "step_ms"))
    argv = ["--matrix-id", "1", "--device", "cpu", "--steps", "1",
            "--disc-cache", str(tmp_path / "cache")]
    built, = transient_bench.main(argv)
    loaded, = transient_bench.main(argv)
    err = capsys.readouterr().err
    assert "disc cache built and saved" in err and "disc cache loaded" in err
    for key in ("newton", "lin", "mean_lin"):
        assert built[key] == loaded[key]
    assert built["disc_s"] > 0 and loaded["disc_s"] > 0
    assert torch.equal(built["state"], loaded["state"])


def test_gmres_decomp_disc_cache(capsys, tmp_path):
    """gmres_decomp with `--disc-cache`: the first run builds and saves the
    discretization, the second loads it; both time every part."""
    argv = ["--matrix-id", "1", "--device", "cpu", "--skip-slope",
            "--disc-cache", str(tmp_path / "cache")]
    first = gmres_decomp.main(argv)
    second = gmres_decomp.main(argv)
    out = capsys.readouterr().out
    assert "disc cache built and saved" in out and "disc cache loaded" in out
    assert set(first) == set(second) and "minv" in second
    assert all(np.isfinite(v) and v > 0 for v in second.values())


def test_gmres_decomp_defaults_are_the_jax_tools(capsys):
    """With no preconditioner, spmv or coarse-agg flag, gmres_decomp at
    matrix 1 prepares what the JAX tool prepares on the same mesh: its
    configuration (two_level, SolverConfig's own spmv, coarse_agg from
    the tool's table, else 48) resolves to the same prep kind, coarse_agg
    and aggregate count."""
    from navierstokes_tpu.bench import gmres_decomp as jgd
    from navierstokes_tpu.config import NewtonConfig as JNewton
    from navierstokes_tpu.mesh.box import scaling_series_mesh as j_series

    gmres_decomp.main(["--matrix-id", "1", "--device", "cpu",
                       "--skip-slope"])
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("ndof="))
    got = dict(kv.split("=") for kv in line.split() if "=" in kv)
    del got["ndof"]

    agg = jgd._COARSE_DEFAULTS.get(1, {}).get("coarse_agg", 48)
    kr = JSolver(rtol=1e-5, atol=1e-6, maxiter=1000, neumann_order=0,
                 preconditioner="two_level", coarse_agg=agg,
                 coarse_dense_max=16384, restart=30, cgs2="xla")
    jcfg = JNS(dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
               newton=JNewton(rtol=1e-4, atol=1e-5, stol=1e-6,
                              du_tol=float("inf")),
               krylov=kr, stokes_krylov=kr)
    js = JSolverModel(j_series(1), jcfg)
    js._ensure_prepared()
    want = {"prep": js._exact_prep[0],
            "preconditioner": js.cfg.krylov.preconditioner,
            "coarse_agg": str(js.cfg.krylov.coarse_agg),
            "n_agg": str(js._coarse_space.n_agg)}
    assert got == want == {"prep": "tl", "preconditioner": "two_level",
                           "coarse_agg": "48", "n_agg": want["n_agg"]}


@pytest.mark.parametrize("matrix_id,want", [(8, 128), (9, 256), (10, 256)])
def test_gmres_decomp_opt_ins_keep_the_size_schedule(matrix_id, want):
    """Under `--preconditioner auto` gmres_decomp leaves coarse_agg to the
    solver's size schedule, as `run.py` does, so it times the product's
    coarse level (matrix 9: 256, where the JAX tool's table falls back to
    48); only two_level takes the table.  Resolved without a run, from the
    series' node count."""
    from navierstokes_tpu_torch.config import resolve_coarse_defaults
    from navierstokes_tpu_torch.mesh.box import SCALING_SERIES_DIMS

    nv = int(np.prod([d + 1 for d in SCALING_SERIES_DIMS[matrix_id]]))
    auto = gmres_decomp.ns_config(gmres_decomp.parse_args(
        ["--matrix-id", str(matrix_id), "--preconditioner", "auto",
         "--device", "cpu"]))
    assert auto.krylov.coarse_agg is None and auto.krylov.spmv == "plane"
    kr = resolve_coarse_defaults(auto, nv).krylov
    assert (kr.preconditioner, kr.coarse_agg) == ("schur", want)
    tl = gmres_decomp.ns_config(gmres_decomp.parse_args(
        ["--matrix-id", str(matrix_id), "--device", "cpu"])).krylov
    assert tl.preconditioner == "two_level"
    assert tl.coarse_agg == gmres_decomp.COARSE_AGG.get(matrix_id, 48)


def test_gmres_decomp_prints_its_lines(capsys):
    """gmres_decomp at matrix 1 on the CPU through the 'sch' prep: a line
    and a finite time for every part of `_prep_operators`, the matvec, the
    CGS2 projection (four GEMVs and K3's plain version) and the slope."""
    rows = gmres_decomp.main(["--matrix-id", "1", "--device", "cpu",
                              "--preconditioner", "schur", "--coarse-agg",
                              "4", "--cgs2", "pallas"])
    out = capsys.readouterr().out
    assert "prep=sch" in out
    for name in ("apply_A", "apply_F", "apply_S", "fhat", "shat", "minv",
                 "matvec = minv(A x)", "per_iteration"):
        assert name in rows and np.isfinite(rows[name]) and rows[name] > 0
        assert name in out or name == "per_iteration"
    assert any("K3" in k for k in rows) and "per-iteration" in out
