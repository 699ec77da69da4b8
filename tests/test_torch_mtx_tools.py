"""The port's `.mtx` I/O (`io/mtx.py`) and its four remaining bench tools
(`create_mat`, `layout_census`, `accuracy_drift`, `ca_bench`) against the
JAX package's, on the CPU at matrix 1 (252 rows).

The two packages assemble in different orders, so files of assembled
operators are compared by their header and (row, col) lists exactly and
their values at rel 1e-12 (float64 round-off); byte equality of the
writers is checked on the same numpy arrays written through both.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.bench import create_mat as jcreate
from navierstokes_tpu.bench import layout_census as jcensus
from navierstokes_tpu.config import NewtonConfig as JNewton
from navierstokes_tpu.config import NSConfig as JNS
from navierstokes_tpu.config import SolverConfig as JSolver
from navierstokes_tpu.io import mtx as jmtx
from navierstokes_tpu.mesh.box import scaling_series_mesh as j_series
from navierstokes_tpu.model import NavierStokesSolver as JModel
from navierstokes_tpu.sparse.bcsr import BCSR4 as JBCSR4
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.bench import accuracy_drift, ca_bench
from navierstokes_tpu_torch.bench import create_mat as tcreate
from navierstokes_tpu_torch.bench import layout_census as tcensus
from navierstokes_tpu_torch.bench import timing
from navierstokes_tpu_torch.io import mtx as tmtx
from navierstokes_tpu_torch.sparse.bcsr import BCSR4

torch.set_num_threads(1)
REL = 1e-12          # float64 assembly in another order: round-off only


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def created(tmp_path_factory):
    """Both create_mat tools at matrix 1 (the port's on the CPU): their
    output directories."""
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("port")
    jcreate.main(["--matrix-id", "1", "--out", str(jdir)])
    paths = tcreate.main(["--matrix-id", "1", "--out", str(tdir),
                          "--device", "cpu"])
    return jdir, tdir, paths


def _header(path):
    with open(path) as f:
        return f.readline(), f.readline()


@pytest.mark.parametrize("kind", ["aij", "aijp", "baij4"])
def test_create_mat_files_match_jax(created, kind):
    """Each .mtx: header exact, (row, col) lists exact, values at rel
    1e-12; the by-component file is the block-node one permuted."""
    jdir, tdir, paths = created
    name = f"matrix1_{kind}.mtx"
    assert paths[kind] == str(tdir / name)
    assert _header(tdir / name) == _header(jdir / name)
    assert _header(tdir / name)[1] == "252 252 9392\n"
    n_t, r_t, c_t, v_t = tmtx.read_mtx(str(tdir / name))
    n_j, r_j, c_j, v_j = jmtx.read_mtx(str(jdir / name))
    assert n_t == n_j == 252
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_array_equal(c_t, c_j)
    assert _rel(v_t, v_j) <= REL


def test_create_mat_npz_matches_jax(created):
    jdir, tdir, paths = created
    t = tmtx.load_bcsr_npz(paths["npz"], torch.float64)
    j = jmtx.load_bcsr_npz(str(jdir / "matrix1_baij4.npz"))
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    assert t.values.dtype == torch.float64
    assert _rel(t.values.numpy(), np.asarray(j.values)) <= REL
    # the Dirichlet rows: identity on their diagonal in both
    np.testing.assert_array_equal(t.values.numpy() == 1.0,
                                  np.asarray(j.values) == 1.0)


def test_writers_are_byte_identical(created, tmp_path):
    """The same numpy arrays through both packages' writers give the same
    bytes, block-node and by-component; `save_bcsr_npz` round-trips
    through both loaders."""
    _, tdir, _ = created
    j = jmtx.load_bcsr_npz(str(tdir / "matrix1_baij4.npz"))
    t = tmtx.load_bcsr_npz(str(tdir / "matrix1_baij4.npz"))
    assert torch.equal(t.values, torch.as_tensor(np.array(j.values)))
    nv = t.nb
    for writer, args in ((("write_mtx"), ()),
                         (("write_mtx_by_component"), (nv,))):
        pt, pj = tmp_path / f"t_{writer}.mtx", tmp_path / f"j_{writer}.mtx"
        getattr(tmtx, writer)(str(pt), t, *args)
        getattr(jmtx, writer)(str(pj), j, *args)
        assert pt.read_bytes() == pj.read_bytes(), writer
    assert (tmp_path / "t_write_mtx.mtx").read_bytes() == (
        tdir / "matrix1_baij4.mtx").read_bytes()
    with pytest.raises(ValueError, match="block rows"):
        tmtx.write_mtx_by_component(str(tmp_path / "x.mtx"), t, nv + 1)

    tmtx.save_bcsr_npz(str(tmp_path / "rt.npz"), t)
    back_t = tmtx.load_bcsr_npz(str(tmp_path / "rt.npz"), torch.float32)
    back_j = jmtx.load_bcsr_npz(str(tmp_path / "rt.npz"))
    assert back_t.values.dtype == torch.float32
    np.testing.assert_array_equal(back_t.indices, t.indices)
    np.testing.assert_array_equal(np.asarray(back_j.values),
                                  t.values.numpy())
    np.testing.assert_array_equal(back_t.values.numpy(),
                                  t.values.numpy().astype(np.float32))


_SYMMETRIC = """%%MatrixMarket matrix coordinate real symmetric
% a comment line
4 4 5
1 1 2.5
2 1 -1.0
3 2 0.25
4 4 7.0
4 1 3.0
"""


def test_read_mtx_symmetric_and_coo_to_csr(tmp_path):
    """A symmetric file's off-diagonal entries come back both ways, as in
    the JAX reader; `coo_to_csr` sums duplicates as the JAX one does; a
    non-coordinate file raises."""
    path = tmp_path / "sym.mtx"
    path.write_text(_SYMMETRIC)
    t, j = tmtx.read_mtx(str(path)), jmtx.read_mtx(str(path))
    assert t[0] == j[0] == 4
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(a, b)
    assert len(t[1]) == 8
    dense = np.zeros((4, 4))
    np.add.at(dense, (t[1], t[2]), t[3])
    np.testing.assert_array_equal(dense, dense.T)

    rng = np.random.default_rng(0)
    rows = rng.integers(0, 6, 40)
    cols = rng.integers(0, 6, 40)
    vals = rng.standard_normal(40)
    for a, b in zip(tmtx.coo_to_csr(6, rows, cols, vals),
                    jmtx.coo_to_csr(6, rows, cols, vals)):
        np.testing.assert_array_equal(a, b)

    (tmp_path / "arr.mtx").write_text(
        "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    with pytest.raises(ValueError, match="coordinate"):
        tmtx.read_mtx(str(tmp_path / "arr.mtx"))


def test_write_mtx_of_assembled_operator_matches_jax(created, tmp_path):
    """write_mtx of a BCSR4 whose values came from the JAX package's
    tensor (through `convert.bcsr_from_jax`) repeats the JAX bytes."""
    jdir, _, _ = created
    j = jmtx.load_bcsr_npz(str(jdir / "matrix1_baij4.npz"))
    t = convert.bcsr_from_jax(JBCSR4(j.indptr, j.indices, j.values))
    assert isinstance(t, BCSR4)
    tmtx.write_mtx(str(tmp_path / "t.mtx"), t)
    assert (tmp_path / "t.mtx").read_bytes() == (
        jdir / "matrix1_baij4.mtx").read_bytes()


@pytest.mark.parametrize("matrix_id", [1, 2, 3])
def test_layout_census_matches_jax(matrix_id):
    t = tcensus.census_one(matrix_id)
    j = jcensus.census_one(matrix_id)
    t.pop("build_s")
    j.pop("build_s")
    assert t == j


def test_layout_census_main_prints_the_table(capsys):
    rows = tcensus.main(["--ids", "1,2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "pattern build: native"
    assert out[1].split() == ["id", "ndof", "nnzb", "K", "N_D", "4N_D+3",
                              "raw", "MB", "DIA", "MB", "bDIA", "MB",
                              "bDIA/DIA"]
    # benchlogs/layout_census.txt, rows 1 and 2
    assert out[2].split() == "1 252 587 81 15 63 0.0 0.1 0.1 0.741".split()
    assert out[3].split() == "2 1584 4686 81 15 63 0.3 0.5 0.4 0.741".split()
    assert [r["id"] for r in rows] == [1, 2]


def test_accuracy_drift_configs_are_the_jax_tools():
    """The two legs' configs equal the JAX tool's, field for field."""
    cfg32, cfg64 = accuracy_drift.drift_configs(12, 1e-3)
    j64 = JNS(dt=1e-3, t_final=12 * 1e-3, reynolds=300.0, delta=0.05,
              dtype="float64", newton=JNewton(), krylov=JSolver(),
              stokes_krylov=JSolver(rtol=1e-12, atol=1e-12, maxiter=2000))
    kr32 = JSolver(rtol=1e-5, atol=1e-6, maxiter=1000, neumann_order=0,
                   preconditioner="two_level", spmv="plane")
    j32 = JNS(dt=1e-3, t_final=12 * 1e-3, reynolds=300.0, delta=0.05,
              dtype="float32",
              newton=JNewton(rtol=1e-4, atol=1e-5, stol=1e-6,
                             du_tol=float("inf")),
              krylov=kr32, stokes_krylov=kr32)
    assert convert.config_from_jax(j64) == cfg64
    assert convert.config_from_jax(j32) == cfg32


def test_accuracy_drift_f64_leg_matches_jax(capsys):
    """run_drift at matrix 1, 3 steps, on the CPU: the f64 leg's state
    equals the JAX package's f64 trajectory at rel 1e-9 (the f64 bar of
    the port's model tests), and the drift is finite and below the JAX
    test's bound of 8e-3 at every checkpoint."""
    res = accuracy_drift.run_drift(1, 3, 1e-3, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[2] for ln in out if ln.startswith("DRIFT ")] == [
        "step=1", "step=2", "step=3"]
    assert out[-1].startswith("DRIFT_SUMMARY id=1 steps=3 ")
    assert [k for k, _ in res.rows] == [1, 2, 3]
    assert all(np.isfinite(v) and v < 8e-3 for _, v in res.rows)
    assert res.u32.dtype == torch.float32 and res.u64.dtype == torch.float64

    _, cfg64 = accuracy_drift.drift_configs(3, 1e-3)
    jcfg = JNS(**{**dataclasses.asdict(cfg64),
                  "newton": JNewton(**dataclasses.asdict(cfg64.newton)),
                  "krylov": JSolver(**dataclasses.asdict(cfg64.krylov)),
                  "stokes_krylov": JSolver(**dataclasses.asdict(
                      cfg64.stokes_krylov))})
    s = JModel(j_series(1), jcfg)
    u = s.stokes_init()
    d, uo = jnp.zeros_like(u), u
    for _ in range(3):
        un, d, _ = s.step(u, uo, d)
        uo, u = u, un
    assert _rel(res.u64.numpy(), np.asarray(u)) <= 1e-9


def test_ca_bench_prints_both_tables(capsys, monkeypatch):
    """ca_bench.main at matrix 1 on the CPU: the fixed-count table (timed
    with short chains here: the CPU's times are not the point) and every
    row of the tolerance sweep, GMRES(30) converged."""
    monkeypatch.setattr(ca_bench, "chained_op_time", functools.partial(
        timing.chained_op_time, r1=1, best_of=1, min_delta=0.0))
    res = ca_bench.main(["--matrix-id", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "ndof=252 prep=tl device=cpu"
    assert [ln.split()[0] for ln in out[1:3]] == ["gmres", "ca_gmres"]
    assert all("per-iter" in ln for ln in out[1:3])
    sweep = [ln for ln in out if " to tol: " in ln]
    assert len(sweep) == len(ca_bench.SWEEP) == 9
    assert sweep[0].startswith("gmres[30]")
    assert sweep[1].startswith("ca_gmres[m=16,mono]")
    assert sweep[-1].startswith("ca_gmres[m=6,newt]")
    assert set(res["fixed"]) == {"gmres", "ca_gmres"}
    assert all(t > 0 for t3 in res["fixed"].values() for t in t3[:2])
    ms, iters, resnorm, converged = res["sweep"]["gmres:30"]
    assert converged and 0 < iters <= 1000 and ms > 0
    for name in ("newton:16", "newton:8"):
        assert res["sweep"][name][3], name
