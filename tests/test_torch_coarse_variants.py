"""The coarse variants (ROADMAP slice 10): the per-aggregate linear basis
and smoothed aggregation.  The host builders (weights, Galerkin matrices,
their float64 inverses) and the plane restriction and prolongation of the
PyTorch package against the JAX package's at rel 1e-10; then a Stokes
solve and one step on 'tlp' with the linear basis, and on 'tlp' and 'tl'
with smoothed aggregation, against the JAX package at rel 1e-9 with equal
GMRES counts, and the JAX prep carried across giving the JAX applies."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.config import NSConfig as JNS
from navierstokes_tpu.config import SolverConfig as JSolver
from navierstokes_tpu.fem import assembly as jas
from navierstokes_tpu.mesh import channel_mesh as j_channel
from navierstokes_tpu.model import NavierStokesSolver as JModel
from navierstokes_tpu.ops.block import block4_inverse as j_block4_inverse
from navierstokes_tpu.solvers import coarse as jco
from navierstokes_tpu.sparse.dia import dia_from_bcsr
from navierstokes_tpu.sparse.dia import diag_blocks_from_dia as j_diag_blocks
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.model.navier_stokes import (
    DenseCoarse,
    DenseLinearCoarse,
)
from navierstokes_tpu_torch.solvers import coarse as co

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def band():
    """The JAX test's operator: channel(4,3,3) linear terms, f64, as DIA;
    its block-diagonal inverse."""
    mesh = j_channel(4, 3, 3, length=2.0)
    disc = jas.build_discretization(mesh, dtype=jnp.float64)
    op = jas.assemble_operator(disc, jnp.zeros(disc.ndof), 0.01, 50.0, 0.1,
                               jas.LINEAR_TERMS)
    dia = dia_from_bcsr(op)
    inv_diag = j_block4_inverse(j_diag_blocks(dia.offsets, dia.data,
                                              mesh.nv),
                                pivot_eps=1e-300, shift=1e-8)
    return mesh, dia, inv_diag


def _spaces(mesh, agg):
    return (jco.build_aggregates(mesh.nv, agg),
            co.build_aggregates(mesh.nv, agg))


@pytest.mark.parametrize("agg", [3, 5])
def test_linear_basis_matches_jax(band, agg):
    """Weights (agg=3 cannot span 4 modes: the inert-mode path), the
    Galerkin matrix and its inverse, and P^T r / P zc on planes."""
    mesh, dia, _ = band
    jcs, cs = _spaces(mesh, agg)
    jw = jco.build_linear_weights(jcs, np.asarray(mesh.coords))
    w = co.build_linear_weights(cs, np.asarray(mesh.coords))
    assert w.shape == (4, cs.nb_pad) and _rel(w, jw) <= 1e-10
    data = torch.tensor(np.asarray(dia.data))
    want = jco.linear_coarse_dense_matrix(jcs, dia.offsets, dia.data, jw,
                                          shift=1e-6)
    got = co.linear_coarse_dense_matrix(cs, dia.offsets, data, w, shift=1e-6)
    assert _rel(got, want) <= 1e-10
    inv = co.linear_coarse_inverse_dia(cs, dia.offsets, data, w, shift=1e-6)
    assert inv.dtype == torch.float64
    assert _rel(inv.numpy(), jco.linear_coarse_inverse_dia(
        jcs, dia.offsets, dia.data, jw, shift=1e-6)) <= 1e-10
    nb, nbp = mesh.nv, cs.nb_pad + 128
    rng = np.random.default_rng(agg)
    rp = np.zeros((4, nbp))
    rp[:, :nb] = rng.standard_normal((4, nb))
    zc = rng.standard_normal(16 * cs.n_agg)
    wt = torch.as_tensor(w)
    assert _rel(co.restrict_planes_linear(cs, torch.as_tensor(rp.ravel()),
                                          nbp, wt).numpy(),
                jco.restrict_planes_linear(jcs, jnp.asarray(rp.ravel()), nbp,
                                           jnp.asarray(jw))) <= 1e-12
    zf = co.prolong_planes_linear(cs, torch.as_tensor(zc), nbp, nb, wt)
    assert _rel(zf.numpy(), jco.prolong_planes_linear(
        jcs, jnp.asarray(zc), nbp, nb, jnp.asarray(jw))) <= 1e-12
    assert not zf.reshape(4, nbp)[:, nb:].any()


@pytest.mark.parametrize("omega", [0.5, 0.6667])
def test_smoothed_aggregation_matches_jax(band, omega):
    """The Petrov-Galerkin matrix of P = (I - omega D^-1 A) P0 and its
    host float64 inverse."""
    mesh, dia, inv_diag = band
    jcs, cs = _spaces(mesh, 4)
    data = torch.tensor(np.asarray(dia.data))
    di = torch.tensor(np.asarray(inv_diag))
    want = jco.smoothed_coarse_dense_matrix(jcs, dia.offsets, dia.data,
                                            inv_diag, omega=omega,
                                            shift=1e-6)
    got = co.smoothed_coarse_dense_matrix(cs, dia.offsets, data, di,
                                          omega=omega, shift=1e-6)
    assert _rel(got, want) <= 1e-10
    inv = co.smoothed_coarse_inverse_dia(cs, dia.offsets, data, di,
                                         omega=omega, shift=1e-6)
    assert _rel(inv.numpy(), jco.smoothed_coarse_inverse_dia(
        jcs, dia.offsets, dia.data, inv_diag, omega=omega,
        shift=1e-6)) <= 1e-10


def test_coarse_operator_inverse_matches_jax():
    """The block-CSR form of the dense coarse inverse, from the JAX
    package's operator carried across, at rel 1e-10."""
    mesh = j_channel(4, 3, 3, length=2.0)
    disc = jas.build_discretization(mesh, dtype=jnp.float64)
    op = jas.assemble_operator(disc, jnp.zeros(disc.ndof), 0.01, 50.0, 0.1,
                               jas.LINEAR_TERMS)
    jcs, cs = _spaces(mesh, 4)
    want = jco.coarse_operator_inverse(jcs, op.values, disc.row_ids,
                                       disc.indices, shift=1e-6)
    got = co.coarse_operator_inverse(cs, convert.bcsr_from_jax(op).values,
                                     disc.row_ids, disc.indices, shift=1e-6)
    assert got.shape == (cs.nc, cs.nc)
    assert _rel(got.numpy(), want) <= 1e-10


def _jax_stokes(js):
    """The JAX Stokes solve, eager, with its GMRES count."""
    prep = js._prepare_operator_dia(js._stokes_assemble_jit(js._consts))
    res = js._solve_prepared(prep, js._stokes_rhs, js.cfg.stokes_krylov)
    return np.asarray(res.x), int(res.iters)


@pytest.mark.parametrize("krylov_kw,kind,coarse", [
    (dict(spmv="plane", coarse_agg=8, coarse_basis="linear"), "tlp",
     DenseLinearCoarse),
    (dict(spmv="plane", coarse_agg=4, coarse_smooth_omega=0.7), "tlp",
     DenseCoarse),
    (dict(spmv="auto", coarse_agg=4, coarse_smooth_omega=0.7), "tl",
     DenseCoarse),
], ids=["tlp-linear", "tlp-sa", "tl-sa"])
def test_variant_solves_match_jax(krylov_kw, kind, coarse):
    kr = JSolver(rtol=1e-12, atol=1e-13, maxiter=4000,
                 preconditioner="two_level", **krylov_kw)
    jcfg = JNS(dt=0.01, reynolds=100.0, delta=0.1, dtype="float64",
               krylov=kr, stokes_krylov=dataclasses.replace(kr, rtol=1e-13))
    jmesh = j_channel(4, 2, 2, obstacle=True)
    js = JModel(jmesh, jcfg)
    ts = NavierStokesSolver(convert.mesh_from_jax(jmesh),
                            convert.config_from_jax(jcfg), device=CPU)
    assert ts.prep_kind == kind
    uj, jits = _jax_stokes(js)
    ut = ts.stokes_init()
    assert ts.stokes_result.converged and ts.stokes_result.iters == jits
    assert _rel(ut.numpy(), uj) <= 1e-9
    uj1, _, sj = js.step(jnp.asarray(uj), jnp.asarray(uj),
                         jnp.zeros_like(jnp.asarray(uj)))
    u0 = torch.tensor(uj)
    ut1, _, st = ts.step(u0, u0, torch.zeros_like(u0))
    assert bool(sj.converged) and st.converged
    assert (st.iters, st.lin_iters) == (int(sj.iters), int(sj.lin_iters))
    assert _rel(ut1.numpy(), uj1) <= 1e-9
    # the JAX prep carried across gives the JAX applies
    tprep = convert.prep_from_jax(js._exact_prep)
    assert tprep.kind == kind and isinstance(tprep.coarse, coarse)
    assert isinstance(ts._exact_prep.coarse, coarse)
    jmv, _, jparts = js._prep_operators(js._exact_prep)
    mv, _, parts = ts._prep_operators(tprep)
    n = tprep.nbp * 4 if kind == "tlp" else ts.disc.ndof
    x = np.random.default_rng(1).standard_normal(n)
    if kind == "tlp":
        x.reshape(4, -1)[:, ts.disc.nv:] = 0.0
    for name in ("coarse", "minv"):
        assert _rel(parts[name](torch.as_tensor(x)).numpy(),
                    jparts[name](jnp.asarray(x))) <= 1e-12, name
    assert _rel(mv(torch.as_tensor(x)).numpy(), jmv(jnp.asarray(x))) <= 1e-12
