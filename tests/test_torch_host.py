"""The port's host layer (config resolution, meshes, patterns, BC table)
against the JAX package, on identical inputs.  Everything here is exact:
the port carries the same numpy code, so the arrays must be equal."""

import dataclasses

import numpy as np
import pytest
import torch

from navierstokes_tpu import config as jcfg
from navierstokes_tpu.fem.assembly import build_discretization as j_build
from navierstokes_tpu.mesh import box as jbox
from navierstokes_tpu_torch import config as tcfg
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.fem.assembly import build_discretization
from navierstokes_tpu_torch.fem.dirichlet import build_dirichlet
from navierstokes_tpu_torch.mesh import box as tbox
from navierstokes_tpu_torch.sparse.bcsr import bcsr_pattern_from_coo

torch.set_num_threads(1)

NDOFS = [10_000, 150_000, 150_004, 600_000, 5_000_000]

KRYLOVS = {
    "default": {},
    "flagship": dict(rtol=1e-5, atol=1e-6, maxiter=1000, neumann_order=0,
                     preconditioner="auto", spmv="plane"),
    "auto_pinned_cheby": dict(preconditioner="auto", spmv="plane",
                              coarse_cheby=2),
    "two_level_pinned_agg": dict(preconditioner="two_level", coarse_agg=64),
}


def test_dataclass_fields_and_defaults_match():
    for name in ("SolverConfig", "NewtonConfig", "NSConfig"):
        a = getattr(jcfg, name)()
        b = getattr(tcfg, name)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    assert tcfg.AUTO_COARSE_DENSE_CAP == jcfg.AUTO_COARSE_DENSE_CAP


@pytest.mark.parametrize("ndof", NDOFS)
def test_auto_schedules_match(ndof):
    assert tcfg.auto_coarse_agg(ndof) == jcfg.auto_coarse_agg(ndof)
    assert tcfg.auto_preconditioner(ndof) == jcfg.auto_preconditioner(ndof)


@pytest.mark.parametrize("ndof", NDOFS)
@pytest.mark.parametrize("kind", sorted(KRYLOVS))
@pytest.mark.parametrize("jacobian", ["exact", "reference"])
def test_resolve_coarse_defaults_matches(ndof, kind, jacobian):
    kw = KRYLOVS[kind]
    j = jcfg.NSConfig(jacobian=jacobian, krylov=jcfg.SolverConfig(**kw),
                      stokes_krylov=jcfg.SolverConfig(**kw))
    t = convert.config_from_jax(j)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    nv = ndof // 4
    rj = jcfg.resolve_coarse_defaults(j, nv)
    rt = tcfg.resolve_coarse_defaults(t, nv)
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)


@pytest.mark.parametrize("dims,obstacle", [((4, 2, 2), False),
                                           ((6, 3, 3), True)])
def test_channel_mesh_matches(dims, obstacle):
    a = jbox.channel_mesh(*dims, obstacle=obstacle)
    b = tbox.channel_mesh(*dims, obstacle=obstacle)
    for f in ("coords", "tets", "node_tags"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    c = convert.mesh_from_jax(a)
    np.testing.assert_array_equal(c.tets, b.tets)


@pytest.mark.parametrize("matrix_id", [1, 2, 3])
def test_scaling_series_mesh_matches(matrix_id):
    a = jbox.scaling_series_mesh(matrix_id)
    b = tbox.scaling_series_mesh(matrix_id)
    for f in ("coords", "tets", "node_tags"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


@pytest.mark.parametrize("dims,obstacle", [((4, 2, 2), False),
                                           ((6, 3, 3), True)])
def test_pattern_and_dirichlet_match(dims, obstacle):
    jm = jbox.channel_mesh(*dims, obstacle=obstacle)
    jd = j_build(jm, dtype=np.float64)
    td = build_discretization(convert.mesh_from_jax(jm), torch.float64,
                              torch.device("cpu"))
    assert td.dia_pattern.offsets == jd.dia_pattern.offsets
    assert td.dia_pattern.ndof == jd.dia_pattern.ndof
    assert td.dia_pattern.nnz == jd.dia_pattern.nnz
    np.testing.assert_array_equal(td.dia_pattern.flat_map,
                                  jd.dia_pattern.flat_map)
    np.testing.assert_array_equal(td.dia_elem_map.numpy(),
                                  np.asarray(jd.dia_elem_map))

    t = jm.tets
    rows = np.repeat(t, 4, axis=1).ravel()
    cols = np.tile(t, (1, 4)).ravel()
    indptr, indices, slots = bcsr_pattern_from_coo(rows, cols, jm.nv)
    np.testing.assert_array_equal(indptr, jd.indptr)
    np.testing.assert_array_equal(indices, jd.indices)
    np.testing.assert_array_equal(slots, jd.slot_of_pair)

    bc = build_dirichlet(convert.mesh_from_jax(jm), torch.float64,
                         torch.device("cpu"))
    np.testing.assert_array_equal(bc.is_bc.numpy(), np.asarray(jd.bc.is_bc))
    np.testing.assert_array_equal(bc.value.numpy(), np.asarray(jd.bc.value))
    np.testing.assert_array_equal(bc.row_bc.numpy(), np.asarray(jd.bc.row_bc))
    assert bc.count == jd.bc.count


def test_geometry_in_run_dtype():
    """float32 runs build the geometry in float32 (no silent promotion)."""
    mesh = tbox.channel_mesh(4, 2, 2)
    d = build_discretization(mesh, torch.float32, torch.device("cpu"))
    assert d.vol.dtype == d.grad.dtype == d.h.dtype == torch.float32
    assert d.bc.value.dtype == torch.float32
    assert bool((d.vol > 0).all())
