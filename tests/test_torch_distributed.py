"""The port's distributed solver (navierstokes_tpu_torch/parallel/) on the
scalar-DIA paths, its refusals and the CLI's `--devices`, against the JAX
package.

The port's shards lie on the CPU (`[cpu] * P`), the JAX package's
distributed solver runs on conftest's 8 virtual CPU devices; both start
every step from the same state, in float64 (tests/torch_distributed_cases.py).
The plane layout's cases are in tests/test_torch_parallel.py.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from navierstokes_tpu.mesh import channel_mesh as j_channel
from navierstokes_tpu_torch import convert, run
from navierstokes_tpu_torch.config import NSConfig, SolverConfig
from navierstokes_tpu_torch.mesh import channel_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.ops import dia as tdia
from navierstokes_tpu_torch.ops.plane_dia import from_planes, to_planes
from navierstokes_tpu_torch.parallel import DistributedNavierStokesSolver
from navierstokes_tpu_torch.parallel import partitioned as tpart

from torch_distributed_cases import CPU, compare_with_jax, jax_config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("krylov_kw", [
    {},
    dict(preconditioner="two_level", coarse_agg=4),
    dict(preconditioner="two_level", coarse_agg=4, coarse_dense_max=32),
], ids=["bj", "tl-dense", "tl-multilevel"])
def test_scalar_paths_match_jax_and_single_device(krylov_kw):
    """'bj' (block-Jacobi + Neumann 2, the f64 default) and 'tl' with the
    dense and the multilevel coarse level (tests/test_parallel.py:110, 429,
    459)."""
    compare_with_jax(krylov_kw)


def test_ca_gmres_power_basis_matches_jax():
    """CA-GMRES on 'bj' without the Neumann boost takes its basis from the
    one-exchange power sweep, in the JAX package and in the port
    (tests/test_parallel.py:225, on a channel long enough that basis * h
    fits a shard of two).  The monomial basis stalls on this Stokes system
    on one device and distributed alike (unconverged, states equal), and
    restarts often in the steps: the counts, whole cycles of 8, are held
    within 2 cycles per Newton solve (measured: 896 distributed, 912 in
    the JAX package, 936 on one device over 4 solves)."""
    kw = dict(neumann_order=0, method="ca_gmres", restart=8, rtol=1e-11,
              atol=1e-12, maxiter=6000)
    mesh = j_channel(48, 2, 2, length=8.0)
    s = DistributedNavierStokesSolver(
        convert.mesh_from_jax(mesh),
        convert.config_from_jax(jax_config(kw, 1e-12)), devices=[CPU] * 2)
    s._ensure_prepared()
    prep = s._exact_prep
    assert 8 * tpart.halo_of(prep.offsets) <= prep.L
    tdia.reset_counters()
    compare_with_jax(kw, P=2, mesh=mesh, stokes_rtol=1e-12,
                     stokes_converges=False, gmres_slack=16)
    # each sweep of the basis is one K2 ghost-row apply on the extended
    # window: its plain version here
    assert tdia.plain_calls > 0


def test_band_fit_errors_match_jax():
    """Too many devices for the band: the JAX package's ValueError, word
    for word."""
    from navierstokes_tpu.parallel import DistributedNavierStokesSolver as J

    import jax

    jmesh = j_channel(2, 2, 2)
    jcfg = jax_config({})
    with pytest.raises(ValueError) as jerr:
        J(jmesh, jcfg, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as terr:
        DistributedNavierStokesSolver(convert.mesh_from_jax(jmesh),
                                      convert.config_from_jax(jcfg),
                                      devices=[CPU] * 8)
    assert "exceeds rows-per-device" in str(terr.value)
    assert str(terr.value) == str(jerr.value)


def _cfg(**kw):
    kr = SolverConfig(rtol=1e-10, atol=1e-12, maxiter=500, **kw)
    return NSConfig(dt=0.01, dtype="float64", krylov=kr, stokes_krylov=kr)


@pytest.mark.parametrize("kw,match", [
    (dict(preconditioner="schur", spmv="plane"), "single-chip"),
    (dict(preconditioner="auto", deflation_k=4), "single-chip"),
    (dict(preconditioner="two_level", coarse_agg=4, coarse_cheby=3),
     "single-chip"),
    (dict(preconditioner="two_level", spmv="plane", coarse_agg=4,
          coarse_basis="linear"), "single-chip"),
    (dict(preconditioner="two_level", coarse_agg=4, cgs2="pallas"),
     "cgs2='pallas' is single-device only"),
    (dict(cgs2="pallas_comp"), "cannot sum its inner products"),
    (dict(method="cg"), "runs GMRES under this name"),
    (dict(method="ca_gmres", ca_basis="newton"), "drops the shifts"),
    (dict(preconditioner="two_level", coarse_agg=4,
          coarse_smooth_omega=0.5), "plain prolongator"),
], ids=["schur", "deflation", "coarse_cheby", "linear", "cgs2", "cgs2-comp",
        "cg", "newton-basis", "sa-omega"])
def test_refusals(kw, match):
    """The JAX package's refusals (tests/test_parallel.py:564,
    test_schur.py:177, test_deflation.py:154, test_config.py:197) with its
    messages, and the port's where the JAX package substitutes silently."""
    with pytest.raises(ValueError, match=match):
        DistributedNavierStokesSolver.from_mesh(
            channel_mesh(12, 2, 2, length=6.0), _cfg(**kw),
            devices=[CPU] * 2)


def test_auto_degrades_with_a_warning():
    """'auto' resolves to plain two_level under distribution, as in the JAX
    package, and says so once; one device keeps the Chebyshev tier."""
    mesh = channel_mesh(6, 2, 2)
    cfg = _cfg(preconditioner="auto")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s = NavierStokesSolver(mesh, cfg, device=CPU)
    assert s.cfg.krylov.coarse_cheby == 3
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        d, _ = DistributedNavierStokesSolver.from_mesh(mesh, cfg,
                                                       devices=[CPU] * 2)
    msgs = [str(w.message) for w in rec if "distribution" in str(w.message)]
    assert len(msgs) == 1, msgs
    assert "coarse_cheby=3" in msgs[0]
    assert d.cfg.krylov.preconditioner == "two_level"
    assert d.cfg.krylov.coarse_cheby == 0
    assert d.user_cfg.krylov.preconditioner == "auto"


def test_shard_kernel_names():
    mesh = channel_mesh(12, 2, 2, length=6.0)
    names = {}
    for kind, kw in (("tlp", dict(preconditioner="two_level", spmv="plane",
                                   coarse_agg=4)),
                     ("tl", dict(preconditioner="two_level", coarse_agg=4)),
                     ("bj", {}), ("xla", dict(spmv="xla"))):
        d, _ = DistributedNavierStokesSolver.from_mesh(mesh, _cfg(**kw),
                                                       devices=[CPU] * 3)
        names[kind] = d.shard_kernel_name()
        assert d.placement().startswith("3 shards on 1 device(s)")
    assert names == {"tlp": "plane_spmv_halo", "tl": "dia_spmv_halo",
                     "bj": "dia_spmv_halo", "xla": "dia_spmv_halo_plain"}


def test_matvec_dtype_runs_k2_bf16_ghost_form():
    """'tl' with matvec_dtype='bfloat16' under distribution: the operator
    shards are bf16, and the steps match the single-device solver (same
    bf16 operator, fixed-order sums within 1e-8)."""
    kw = dict(preconditioner="two_level", coarse_agg=4,
              matvec_dtype="bfloat16")
    mesh = channel_mesh(12, 2, 2, length=6.0)
    cfg = _cfg(**kw)
    d, _ = DistributedNavierStokesSolver.from_mesh(mesh, cfg,
                                                   devices=[CPU] * 4)
    s = NavierStokesSolver(mesh, cfg, device=CPU)
    u0 = s.stokes_init()
    ud, _, sd = d.step(u0, u0, torch.zeros_like(u0))
    us, _, ss = s.step(u0, u0, torch.zeros_like(u0))
    assert d._exact_prep.op.parts[0].dtype == torch.bfloat16
    assert sd.converged and sd.iters == ss.iters
    assert abs(sd.lin_iters - ss.lin_iters) <= 2 * sd.iters
    assert float(torch.linalg.norm(ud - us) / torch.linalg.norm(us)) <= 1e-8


def test_cli_devices_on_the_cpu():
    """`--devices 4 --device cpu` runs the distributed solver, 4 shards on
    the CPU, through run.main."""
    out = run.main(["--nx", "12", "--ny", "2", "--nz", "2", "--steps", "1",
                    "--devices", "4", "--device", "cpu", "--dtype",
                    "float32"])
    s = out.solver
    assert isinstance(s, DistributedNavierStokesSolver)
    assert s.devices == [CPU] * 4
    assert s.prep_kind == "tlp" and s.cfg.krylov.coarse_cheby == 0
    assert s.history[0][1].converged
    assert np.all(np.isfinite(out.u.numpy()))


def test_parallel_imports_leave_jax_out():
    code = ("import sys, navierstokes_tpu_torch.parallel\n"
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


@pytest.mark.cuda
def test_distributed_step_on_the_card_equals_the_cpu():
    """On the card, four shards of cuda:0: the 'tlp' step's Newton and GMRES
    counts and state against the same run on the CPU (rel 1e-9, GMRES
    within 1 per solve: the kernel and its plain version sum in another
    order), through K1's ghost-row form with no plain call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from navierstokes_tpu_torch.ops import plane_dia as tpd

    cfg = _cfg(preconditioner="two_level", spmv="plane", coarse_agg=4)
    mesh = channel_mesh(24, 2, 2, length=6.0)
    out = {}
    for dev in (CPU, torch.device("cuda", 0)):
        d, _ = DistributedNavierStokesSolver.from_mesh(mesh, cfg,
                                                       devices=[dev] * 4)
        u0 = d.stokes_init()
        tpd.reset_counters()
        u, _, st = d.step(u0, u0, torch.zeros_like(u0))
        out[dev.type] = (u.cpu(), st, tpd.halo_launches, tpd.plain_calls)
    (uc, sc, _, _), (ug, sg, halo, plain) = out["cpu"], out["cuda"]
    assert halo > 0 and plain == 0
    assert sg.iters == sc.iters
    assert abs(sg.lin_iters - sc.lin_iters) <= sg.iters
    assert float(torch.linalg.norm(ug - uc) / torch.linalg.norm(uc)) <= 1e-9


@pytest.mark.parametrize("kind,kw", [
    ("tl", dict(preconditioner="two_level", coarse_agg=4)),
    ("tlp", dict(preconditioner="two_level", spmv="plane", coarse_agg=6)),
    ("bj", {}),
])
def test_shard_layout_rules(kind, kw):
    """Each shard holds at least the halo; on 'tl' a multiple of 4 * agg
    rows, on 'tlp' a multiple of agg nodes and of a 16-byte unit, so every
    aggregate lives on one shard; padding rows of the prepared operator
    are exact zeros.  The cycle pieces the distributed operators share
    with the single-device ones (`solvers/cycle.py`, the plane and
    interleaved transfers on a shard's aggregates) give the single-device
    matvec and b_prep on the shard layout (rel 1e-12), padding rows
    exactly zero."""
    mesh = channel_mesh(12, 2, 2, length=6.0)
    d, _ = DistributedNavierStokesSolver.from_mesh(mesh, _cfg(**kw),
                                                   devices=[CPU] * 3)
    d._ensure_prepared()
    prep = d._exact_prep
    assert prep.kind == kind
    L, P = prep.L, 3
    assert L >= tpart.halo_of(prep.offsets)
    agg = d.cfg.krylov.coarse_agg
    if kind == "tl":
        assert L % (4 * agg) == 0
    if kind == "tlp":
        assert L % agg == 0 and (L * 8) % 16 == 0
    live = tpart.shard_rows(prep.n, L, P)
    assert sum(live) == prep.n and 0 < live[-1] <= L
    assert torch.all(prep.op.parts[-1][..., live[-1]:] == 0)
    assert kind == "bj" or live[-1] < L

    single = NavierStokesSolver(d.disc.mesh, d.cfg, disc=d.disc, device=CPU)
    single._ensure_prepared()
    sprep = single._exact_prep
    assert sprep.kind == kind
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        d.disc.ndof))
    for f, g in zip(d._prep_operators(prep)[:2],
                    single._prep_operators(sprep)[:2]):
        y = f(d._split(prep, x))
        pad = y.parts[-1].reshape(4, L) if kind == "tlp" else y.parts[-1]
        assert torch.all(pad[..., live[-1]:] == 0)
        if kind == "tlp":
            want = from_planes(g(to_planes(x, sprep.nb, sprep.nbp)),
                               sprep.nb, sprep.nbp)
        else:
            want = g(x)
        got = d._join(prep, y)
        assert float(torch.linalg.norm(got - want)
                     / torch.linalg.norm(want)) <= 1e-12
