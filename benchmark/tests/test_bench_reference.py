"""The benchmark's frozen copies against the program they were copied from:
the mesh generator, the Dirichlet data, the padding rule and the
element-by-element operators, at a small size and at matrix 6.  (These
tests import the program; the reference itself imports none of it.)

    python -m pytest benchmark/tests -q
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import fem, padding, problem
from benchmark.reference.mesh import channel_mesh
from navierstokes_tpu_torch.config import auto_coarse_agg
from navierstokes_tpu_torch.fem.assembly import (
    LINEAR_TERMS,
    STOKES_TERMS,
    assemble_dia_values,
    build_discretization,
)
from navierstokes_tpu_torch.fem.dirichlet import build_dirichlet
from navierstokes_tpu_torch.mesh.box import (
    SCALING_SERIES_DIMS,
    channel_mesh as port_channel_mesh,
    scaling_series_mesh,
)
from navierstokes_tpu_torch.ops.dia import spmv_dia_plain
from navierstokes_tpu_torch.ops.plane_dia import plane_nbp
from navierstokes_tpu_torch.solvers.coarse import build_aggregates

REFERENCE = Path(__file__).resolve().parent.parent / "reference"
SIZES = [pytest.param((8, 4, 4, True), id="small"),
         pytest.param(SCALING_SERIES_DIMS[6] + (True,), id="matrix6")]


@pytest.mark.parametrize("dims", SIZES)
def test_mesh_copy_equals_the_program(dims):
    nx, ny, nz, obstacle = dims
    coords, tets, tags = channel_mesh(nx, ny, nz, obstacle=obstacle)
    port = port_channel_mesh(nx, ny, nz, length=4.0, obstacle=obstacle)
    assert np.array_equal(coords, port.coords)
    assert np.array_equal(tets, port.tets)
    assert np.array_equal(tags, port.node_tags)


def test_mesh_copy_equals_the_scaling_series_at_matrix_6():
    coords, tets, tags = channel_mesh(*SCALING_SERIES_DIMS[6], obstacle=True)
    port = scaling_series_mesh(6)
    assert coords.shape == (29_375, 3)
    for a, b in ((coords, port.coords), (tets, port.tets),
                 (tags, port.node_tags)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dims", SIZES)
def test_dirichlet_copy_equals_the_program(dims):
    coords, tets, tags = channel_mesh(*dims[:3], obstacle=dims[3])
    port = build_dirichlet(port_channel_mesh(*dims[:3], obstacle=dims[3]),
                           torch.float64, torch.device("cpu"))
    is_bc, value = problem.dirichlet(coords, tags)
    assert np.array_equal(is_bc, port.is_bc.numpy())
    assert np.array_equal(value, port.value.numpy())


@pytest.mark.parametrize("matrix_id", range(1, 11))
def test_padding_rule_equals_the_program(matrix_id):
    nx, ny, nz = SCALING_SERIES_DIMS[matrix_id]
    nv = (nx + 1) * (ny + 1) * (nz + 1)
    agg = auto_coarse_agg(4 * nv)
    assert padding.plane_rows(nv) == plane_nbp(
        nv, build_aggregates(nv, agg).nb_pad)
    assert padding.plane_rows(nv, 4) == plane_nbp(
        nv, build_aggregates(nv, 4).nb_pad)


@pytest.mark.parametrize("dims", SIZES)
def test_element_operators_equal_the_programs_assembly(dims):
    """A U element by element (the reference) against the program's
    assembled DIA operator applied by K1's plain neighbour, K2's plain
    version, both in float64."""
    coords, tets, tags = channel_mesh(*dims[:3], obstacle=dims[3])
    dt, re, re_s, delta = 1e-3, 300.0, 0.01, 0.05
    ops = fem.ElementOperators(coords, tets, dt=dt, reynolds=re,
                               stokes_reynolds=re_s, delta=delta,
                               device="cpu")
    disc = build_discretization(port_channel_mesh(*dims[:3],
                                                  obstacle=dims[3]),
                                torch.float64, torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    U = torch.randn(disc.ndof, 2, generator=gen, dtype=torch.float64)
    for terms, port_terms, reynolds in (
            (fem.LINEAR, LINEAR_TERMS, re), (fem.STOKES, STOKES_TERMS, re_s),
            (fem.MASS, frozenset({"mass_dt_bare"}), re)):
        data = assemble_dia_values(
            disc.vol, disc.grad, disc.h, dt, reynolds, delta,
            disc.dia_elem_map, terms=port_terms, K=disc.dia_pattern.K,
            ndof=disc.ndof)
        want = torch.stack([spmv_dia_plain(disc.dia_pattern.offsets, data,
                                           U[:, i]) for i in range(2)], 1)
        got = ops.apply(terms, U, reynolds)
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 1e-12, (sorted(terms), err)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    names = set()
    for path in REFERENCE.glob("*.py"):
        names |= _imports(path)
    assert names <= {"__future__", "itertools", "numpy", "torch",
                     "benchmark"}, names
    code = ("import sys; import benchmark.reference.problem, "
            "benchmark.reference.padding; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=REFERENCE.parent.parent).stdout
    loaded = set(eval(out))
    assert not loaded & {"navierstokes_tpu_torch", "navierstokes_tpu", "jax",
                         "jaxlib", "flax"}, loaded
