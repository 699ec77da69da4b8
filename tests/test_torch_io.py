"""The port's input and output against the JAX package's: the Gmsh reader
and writer, RCM ordering, the `.vtu`/`.pvd` writer, checkpoints (their
config fingerprint, a checkpoint crossing from the JAX package, resume
against an uninterrupted run), the discretization cache and the span
log.  Inputs are made with numpy from a seed, or are inline `.msh` text,
and handed to both packages."""

import dataclasses
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.config import NSConfig as JNS
from navierstokes_tpu.config import SolverConfig as JSolver
from navierstokes_tpu.io import checkpoint as jck
from navierstokes_tpu.io import vtu as jvtu
from navierstokes_tpu.mesh import box as jbox
from navierstokes_tpu.mesh import gmsh as jgmsh
from navierstokes_tpu.mesh import ordering as jord
from navierstokes_tpu_torch import convert, run
from navierstokes_tpu_torch.config import NSConfig, SolverConfig
from navierstokes_tpu_torch.fem.assembly import (
    build_discretization,
    cached_discretization,
    is_discretization_cache,
    load_discretization,
    save_discretization,
)
from navierstokes_tpu_torch.io import checkpoint as tck
from navierstokes_tpu_torch.io import vtu as tvtu
from navierstokes_tpu_torch.mesh import channel_mesh
from navierstokes_tpu_torch.mesh import gmsh as tgmsh
from navierstokes_tpu_torch.mesh import ordering as tord
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.utils.profiling import EventLog

torch.set_num_threads(1)
CPU = torch.device("cpu")

# A Gmsh 2.2 file with every reader rule the writer never produces: quad
# facets (type 3); tags[0] never scanned (even when it looks collected);
# the first collected tag of a facet wins (6 before 3); the last facet to
# name a node wins; point (15) and line (1) elements skipped.
QUAD_MIXED_MSH = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
9
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
5 0 0 1
6 1 0 1
7 1 1 1
8 0 1 1
9 0.5 0.5 0.5
$EndNodes
$Elements
10
1 15 2 0 1 9
2 1 2 0 1 1 2
3 3 2 2 2 1 2 3 4
4 3 2 2 0 5 6 7 8
5 2 3 0 6 3 2 6 7
6 2 2 4 4 3 4 8
7 2 2 1 1 5 6 9
8 4 2 0 0 1 2 3 9
9 4 2 0 0 1 3 4 9
10 4 2 0 0 5 6 7 9
$EndElements
"""
QUAD_MIXED_TAGS = np.array([2, 6, 4, 4, 1, 1, 6, 4, 1], dtype=np.int32)

# The same node written twice in $Nodes order and an element line with
# extra vertices past the tet's four: the ids column is not read, and a
# tet keeps its first four vertices.
NO_TAGS_MSH = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
7 0 0 0
3 1 0 0
9 0 1 0
1 0 0 1
$EndNodes
$Elements
1
1 4 2 0 0 1 2 3 4
$EndElements
"""


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))


def _same_mesh(a, b):
    for field in ("coords", "tets", "node_tags"):
        np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                      np.asarray(getattr(b, field)))


@pytest.mark.parametrize("text", [QUAD_MIXED_MSH, NO_TAGS_MSH],
                         ids=["quad_mixed", "no_tags"])
def test_gmsh_reader_matches_jax(text, tmp_path):
    """The port's reader against the JAX package's Python reader (its
    semantic oracle) and its `read_gmsh` (the native parser where built),
    on inline text."""
    path = str(tmp_path / "m.msh")
    with open(path, "w") as f:
        f.write(text)
    m = tgmsh.read_gmsh(path)
    _same_mesh(m, jgmsh._read_gmsh_py(path))
    _same_mesh(m, jgmsh.read_gmsh(path))
    if text is QUAD_MIXED_MSH:
        np.testing.assert_array_equal(m.node_tags, QUAD_MIXED_TAGS)
        assert m.tets.shape == (3, 4)


def test_gmsh_reader_needs_nodes(tmp_path):
    path = str(tmp_path / "empty.msh")
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="Nodes"):
        tgmsh.read_gmsh(path)


@pytest.mark.parametrize("args", [(3, 2, 2, False), (8, 4, 4, False),
                                  (6, 3, 3, True)])
def test_write_gmsh_byte_identical(args, tmp_path):
    """`write_gmsh` writes the JAX package's bytes (the boundary triangles
    of uniform tag in the order first met, then the tets), and a round
    trip never gives a node a wrong tag: each keeps its tag or drops to
    -1 (the documented limitation)."""
    jm = jbox.channel_mesh(*args[:3], obstacle=args[3])
    tm = convert.mesh_from_jax(jm)
    pj, pt = tmp_path / "j.msh", tmp_path / "t.msh"
    jgmsh.write_gmsh(jm, str(pj))
    tgmsh.write_gmsh(tm, str(pt))
    assert pt.read_bytes() == pj.read_bytes()
    back = tgmsh.read_gmsh(str(pt))
    _same_mesh(back, jgmsh._read_gmsh_py(str(pj)))
    np.testing.assert_allclose(back.coords, tm.coords, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(back.tets, tm.tets)
    changed = back.node_tags != tm.node_tags
    assert np.all(back.node_tags[changed] == -1)


@pytest.mark.parametrize("seed", [0, 1])
def test_rcm_and_bandwidth_match_jax(seed):
    """RCM on a shuffled channel: the same permutation as the JAX
    package's numpy RCM, the same block bandwidth before and after, and
    the same choice of `best_ordering`."""
    jm = jbox.channel_mesh(6, 3, 3, obstacle=True)
    perm = np.random.default_rng(seed).permutation(jm.nv).astype(np.int32)
    js = jord.reorder_mesh(jm, perm)
    ts = tord.reorder_mesh(convert.mesh_from_jax(jm), perm)
    _same_mesh(ts, js)
    rcm = tord.rcm_ordering(ts)
    np.testing.assert_array_equal(rcm, jord._rcm_ordering_py(js))
    assert tord.block_bandwidth(ts) == jord.block_bandwidth(js)
    fixed = tord.reorder_mesh(ts, rcm)
    assert tord.block_bandwidth(fixed) == jord.block_bandwidth(
        jord.reorder_mesh(js, rcm)) < tord.block_bandwidth(ts)
    np.testing.assert_array_equal(tord.best_ordering(ts),
                                  jord.best_ordering(js))
    # the generator's own numbering is already near-optimal
    tm = convert.mesh_from_jax(jm)
    np.testing.assert_array_equal(tord.best_ordering(tm),
                                  jord.best_ordering(jm))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_write_vtu_and_pvd_byte_identical(dtype, tmp_path):
    """`.vtu` (mesh, velocity, pressure) and `.pvd` bytes equal the JAX
    package's for the same mesh and state, f64 and f32."""
    jm = jbox.channel_mesh(4, 2, 2, obstacle=False)
    tm = convert.mesh_from_jax(jm)
    u = np.random.default_rng(3).standard_normal(4 * jm.nv).astype(dtype)
    jvtu.write_vtu(str(tmp_path / "j.vtu"), jm, jnp.asarray(u))
    tvtu.write_vtu(str(tmp_path / "t.vtu"), tm, torch.as_tensor(u))
    assert (tmp_path / "t.vtu").read_bytes() == \
        (tmp_path / "j.vtu").read_bytes()
    entries = [(1, "solution_0001.vtu"), (2, "solution_0002.vtu")]
    jvtu.write_pvd(str(tmp_path / "j.pvd"), entries)
    tvtu.write_pvd(str(tmp_path / "t.pvd"), entries)
    assert (tmp_path / "t.pvd").read_bytes() == \
        (tmp_path / "j.pvd").read_bytes()


def _cli_config(dtype: str):
    """The CLI's configs (JAX, port) of one dtype: the same fields."""
    from navierstokes_tpu.config import NewtonConfig as JNewton
    from navierstokes_tpu.run import default_f32_krylov as j_f32

    from navierstokes_tpu_torch.config import NewtonConfig

    if dtype == "float32":
        jn = JNewton(rtol=1e-4, atol=1e-5, stol=1e-6, du_tol=float("inf"))
        tn = NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                          du_tol=float("inf"))
        jk, tk = j_f32(), run.default_f32_krylov()
        jsk, tsk = jk, tk
    else:
        jn, tn = JNewton(), NewtonConfig()
        jk, tk = JSolver(), SolverConfig()
        jsk = JSolver(rtol=1e-12, atol=1e-12, maxiter=2000)
        tsk = SolverConfig(rtol=1e-12, atol=1e-12, maxiter=2000)
    kw = dict(dt=1e-3, t_final=1.0, reynolds=300.0, delta=0.05, dtype=dtype)
    return (JNS(newton=jn, krylov=jk, stokes_krylov=jsk, **kw),
            NSConfig(newton=tn, krylov=tk, stokes_krylov=tsk, **kw))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_config_fingerprints_match_jax(dtype):
    """The port's config is field for field the JAX one, so the two
    fingerprints of the CLI's config are equal; a changed field changes
    both alike."""
    jcfg, tcfg = _cli_config(dtype)
    assert tck.config_fingerprint(tcfg) == jck._config_fingerprint(jcfg)
    assert tck.config_fingerprint(convert.config_from_jax(jcfg)) == \
        jck._config_fingerprint(jcfg)
    j2 = dataclasses.replace(jcfg, dt=2e-3)
    t2 = dataclasses.replace(tcfg, dt=2e-3)
    assert tck.config_fingerprint(t2) == jck._config_fingerprint(j2) != \
        jck._config_fingerprint(jcfg)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the JAX package's CLI wrote (f64 on channel(3,2,2), at
    step 2 of a 3-step run) resumes in the port's CLI to step 3, and the
    port's step 3 equals the JAX run's step 3 at rel 1e-9; the port
    refuses it under another config."""
    from navierstokes_tpu.run import main as jmain

    ck = str(tmp_path / "ck.npz")
    small = ["--nx", "3", "--ny", "2", "--nz", "2", "--dtype", "float64"]
    u3_jax = np.asarray(jmain(small + ["--cpu", "--steps", "3",
                                       "--checkpoint", ck,
                                       "--checkpoint-every", "2"]))
    out = run.main(small + ["--device", "cpu", "--steps", "3", "--resume",
                            ck])
    assert [h[0] for h in out.solver.history] == [3]
    assert _rel(out.u.numpy(), u3_jax) <= 1e-9
    with pytest.raises(ValueError, match="fingerprint"):
        run.main(small + ["--device", "cpu", "--steps", "3", "--resume", ck,
                          "--re", "100"])


def test_resume_equals_uninterrupted(tmp_path):
    """The model's run(): 2 steps with a checkpoint, then a resume to step
    4, against 4 uninterrupted steps (rel 1e-13, the JAX package's bar;
    on one device the two are equal bit for bit), with global step
    numbering in the .dat files after the resume."""
    kr = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000)
    cfg = NSConfig(dt=0.01, reynolds=100.0, delta=0.1, dtype="float64",
                   krylov=kr, stokes_krylov=kr)
    mesh = channel_mesh(4, 2, 2)
    ck = str(tmp_path / "ck.npz")
    a = NavierStokesSolver(mesh, cfg, device=CPU)
    u0 = a.stokes_init()
    a.run(2, u0=u0, checkpoint_path=ck, checkpoint_every=2, monitor=False)
    step, u, u_old, du = tck.load_checkpoint(ck, cfg=cfg)
    assert step == 2 and np.array_equal(u, u_old)
    b = NavierStokesSolver(mesh, cfg, disc=a.disc, device=CPU)
    res = str(tmp_path / "res")
    u4 = b.run(2, u0=u, start_step=step, delta_u0=du, save_dir=res,
               save_every=1, monitor=False)
    whole = NavierStokesSolver(mesh, cfg, disc=a.disc, device=CPU).run(
        4, u0=u0, monitor=False)
    assert _rel(u4.numpy(), whole.numpy()) <= 1e-13
    assert torch.equal(u4, whole)
    assert sorted(os.listdir(res)) == ["solution_step0003.dat",
                                       "solution_step0004.dat"]
    with pytest.raises(ValueError, match="fingerprint"):
        tck.load_checkpoint(ck, cfg=dataclasses.replace(cfg, dt=0.02))


def test_disc_cache_round_trip(tmp_path):
    """A discretization saved and loaded again (the port's own format,
    .npy without pickles) gives a Stokes solve equal bit for bit to one
    from a fresh build; `cached_discretization` builds and saves once,
    then loads; a JAX package cache is refused by name."""
    mesh = channel_mesh(4, 2, 2, obstacle=True)
    cache = str(tmp_path / "cache")
    fresh = build_discretization(mesh, torch.float64, CPU)
    disc, loaded = cached_discretization(cache, lambda: mesh, torch.float64,
                                         CPU)
    assert not loaded and is_discretization_cache(cache)
    again, loaded = cached_discretization(cache, lambda: None,
                                          torch.float64, CPU)
    assert loaded
    for name in ("tets", "vol", "grad", "h", "dia_elem_map"):
        assert torch.equal(getattr(again, name), getattr(fresh, name)), name
    assert again.dia_pattern.offsets == fresh.dia_pattern.offsets
    assert again.dia_pattern.scaled_terms == fresh.dia_pattern.scaled_terms
    assert again.dia_pattern.nnz == fresh.dia_pattern.nnz
    _same_mesh(again.mesh, mesh)
    kr = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000)
    cfg = NSConfig(dtype="float64", krylov=kr, stokes_krylov=kr)
    u_fresh = NavierStokesSolver(mesh, cfg, device=CPU).stokes_init()
    u_cache = NavierStokesSolver(again.mesh, cfg, disc=again,
                                 device=CPU).stokes_init()
    assert torch.equal(u_cache, u_fresh)
    # float32 geometry from the same cache: computed anew, as a fresh build
    f32 = load_discretization(cache, torch.float32, CPU)
    assert torch.equal(f32.grad, build_discretization(
        mesh, torch.float32, CPU).grad)

    jax_dir = tmp_path / "jax_cache"
    jax_dir.mkdir()
    (jax_dir / "mesh.pkl").write_bytes(b"")
    with pytest.raises(ValueError, match="JAX package's pickled cache"):
        cached_discretization(str(jax_dir), lambda: mesh, torch.float64, CPU)
    save_discretization(fresh, str(tmp_path / "other"))
    assert sorted(os.listdir(tmp_path / "other")) == sorted(
        f"{n}.npy" for n in ("coords", "tets", "node_tags", "dia_offsets",
                             "dia_flat_map", "dia_elem_map", "format"))


def test_event_log_report():
    """The span tree: nesting by path, counts, total and self seconds (the
    total less what child spans cover), read by (name, parent) and
    printed as an indented table, children by total time."""
    log = EventLog()
    for _ in range(3):
        log.enter("iter")
        log.enter("apply")
        time.sleep(0.002)
        log.exit()
        log.enter("sync")
        log.exit()
        log.exit()
    log.enter("apply")
    log.exit()
    snap = log.snapshot()
    assert set(snap) == {("iter", None), ("apply", "iter"), ("sync", "iter"),
                         ("apply", None)}
    n_it, tot_it, self_it = snap[("iter", None)]
    n_ap, tot_ap, self_ap = snap[("apply", "iter")]
    assert (n_it, n_ap, snap[("sync", "iter")][0]) == (3, 3, 3)
    assert snap[("apply", None)][0] == 1
    assert tot_ap >= 0.006 and self_ap == tot_ap
    assert self_it == pytest.approx(
        tot_it - tot_ap - snap[("sync", "iter")][1], abs=1e-12)
    assert 0 <= self_it <= tot_it
    lines = log.report().splitlines()
    assert lines[0].split() == ["Span", "Count", "Total", "(s)", "Self",
                                "(s)", "Avg", "(ms)"]
    assert [ln.split()[:2] for ln in lines[1:]] == [
        ["iter", "3"], ["apply", "3"], ["sync", "3"], ["apply", "1"]]
    assert lines[2].startswith("  apply") and lines[4].startswith("apply")
