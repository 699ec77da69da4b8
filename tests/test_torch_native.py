"""The port's native host library (`navierstokes_tpu_torch/native/`)
against its numpy and Python versions and the JAX package's: the cases of
`tests/test_native.py`, compared for equality.

g++ is present wherever these tests run, so the library is built here (at
first use, into `navierstokes_tpu_torch/_build/`) and every test checks
that it really was loaded.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from navierstokes_tpu.mesh import box as jbox
from navierstokes_tpu.mesh import gmsh as jgmsh
from navierstokes_tpu.mesh import ordering as jord
from navierstokes_tpu.sparse.bcsr import bcsr_pattern_from_coo
from navierstokes_tpu_torch import convert, native
from navierstokes_tpu_torch.fem import assembly as tas
from navierstokes_tpu_torch.mesh import gmsh as tgmsh
from navierstokes_tpu_torch.mesh import ordering as tord

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def loaded():
    assert native.available() and native.backend() == "native"
    assert native._state["lib"] is not None


def test_library_is_built_from_the_port_source():
    """The loaded library is the one `library_path` names, under the
    port's `_build/`, keyed on the port's own copy of the source."""
    path = native.library_path(native._cxx())
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.parent.parent.name == "navierstokes_tpu_torch"
    assert native._state["lib"]._name == str(path)


def test_gmsh_parser_matches_python(tmp_path):
    jm = jbox.channel_mesh(5, 3, 3, length=2.0, obstacle=True)
    path = str(tmp_path / "m.msh")
    jgmsh.write_gmsh(jm, path)
    coords, tets, tags = native.parse_gmsh_native(path)
    for ref in (tgmsh.read_gmsh_py(path), jgmsh._read_gmsh_py(path)):
        np.testing.assert_array_equal(coords, ref.coords)
        np.testing.assert_array_equal(tets, ref.tets)
        np.testing.assert_array_equal(tags, ref.node_tags)
    m = tgmsh.read_gmsh(path)
    np.testing.assert_array_equal(m.tets, tets)


def test_gmsh_parser_missing_file():
    with pytest.raises(ValueError, match="cannot open"):
        native.parse_gmsh_native("/nonexistent/path.msh")
    with pytest.raises(ValueError, match="cannot open"):
        tgmsh.read_gmsh("/nonexistent/path.msh")


@pytest.mark.parametrize("args", [(4, 3, 3, False), (6, 3, 3, True)])
def test_pattern_matches_numpy(args):
    """The native pattern equals the port's numpy build and the JAX
    package's `bcsr_pattern_from_coo`, array for array and dtype for
    dtype; `block_pattern` takes the native one."""
    jm = jbox.channel_mesh(*args[:3], length=2.0, obstacle=args[3])
    tm = convert.mesh_from_jax(jm)
    built = native.build_pattern_native(tm.nv, tm.tets)
    t = jm.tets
    ref = bcsr_pattern_from_coo(np.repeat(t, 4, axis=1).ravel(),
                                np.tile(t, (1, 4)).ravel(), jm.nv)
    for other in (tas.block_pattern_numpy(tm), ref, tas.block_pattern(tm)):
        for a, b in zip(built, other):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.int32
    with pytest.raises(ValueError, match="outside"):
        native.build_pattern_native(tm.nv - 1, tm.tets)


@pytest.mark.parametrize("seed", [0, 1])
def test_rcm_matches_python(seed):
    """Native RCM gives the same permutation as the port's Python RCM and
    the JAX package's, on a shuffled channel."""
    jm = jbox.channel_mesh(8, 3, 3, length=4.0)
    perm = np.random.default_rng(seed).permutation(jm.nv).astype(np.int32)
    js = jord.reorder_mesh(jm, perm)
    ts = convert.mesh_from_jax(js)
    indptr, indices, _ = native.build_pattern_native(ts.nv, ts.tets)
    rcm = native.rcm_native(ts.nv, indptr, indices)
    assert sorted(rcm.tolist()) == list(range(ts.nv))
    np.testing.assert_array_equal(rcm, tord.rcm_ordering_py(ts))
    np.testing.assert_array_equal(rcm, jord._rcm_ordering_py(js))
    np.testing.assert_array_equal(tord.rcm_ordering(ts), rcm)


def test_without_a_compiler_the_numpy_path_runs(monkeypatch, tmp_path):
    """Where no g++ is found the callers take their numpy and Python
    versions, with equal output."""
    jm = jbox.channel_mesh(4, 2, 2, obstacle=True)
    tm = convert.mesh_from_jax(jm)
    path = str(tmp_path / "m.msh")
    tgmsh.write_gmsh(tm, path)
    with_lib = (tas.block_pattern(tm), tord.rcm_ordering(tm),
                tgmsh.read_gmsh(path))
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setattr(native, "_cxx", lambda: None)
    assert not native.available() and native.backend() == "numpy"
    assert native.build_pattern_native(tm.nv, tm.tets) is None
    for a, b in zip(tas.block_pattern(tm), with_lib[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tord.rcm_ordering(tm), with_lib[1])
    m = tgmsh.read_gmsh(path)
    for field in ("coords", "tets", "node_tags"):
        np.testing.assert_array_equal(getattr(m, field),
                                      getattr(with_lib[2], field))
    disc = tas.build_discretization(tm, torch.float64, torch.device("cpu"))
    np.testing.assert_array_equal(disc.indices, with_lib[0][1])


_BUILD = """
import sys
from pathlib import Path
from navierstokes_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
path = native.build(native._cxx())
native._declare(__import__("ctypes").CDLL(str(path)))
print(path)
"""


def test_concurrent_builds_into_one_directory(tmp_path):
    """Four processes that build into one empty directory at once all load
    the same library: each compiles to its own temporary file and
    `os.replace` puts it in place whole."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for _ in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.strip())
    finally:
        for p in procs:
            p.kill()
    assert len(set(outs)) == 1
    assert [f.name for f in tmp_path.iterdir()] == [os.path.basename(outs[0])]
