"""The port's solver pieces (GMRES, Arnoldi, the two-level coarse space:
restriction and prolongation on both layouts, the dense inverse and the
sparse multilevel A_c) against the JAX package on identical numpy-seeded
inputs, f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.fem import assembly as jas
from navierstokes_tpu.mesh import box as jbox
from navierstokes_tpu.solvers import coarse as jco
from navierstokes_tpu.solvers.deflation import arnoldi as j_arnoldi
from navierstokes_tpu.solvers.gmres import gmres as j_gmres
from navierstokes_tpu.sparse import dia as jdia
from navierstokes_tpu_torch.ops.plane_dia import plane_nbp
from navierstokes_tpu_torch.solvers import coarse as tco
from navierstokes_tpu_torch.solvers.deflation import arnoldi
from navierstokes_tpu_torch.solvers.gmres import gmres

torch.set_num_threads(1)


def _system(n, seed, shift=4.0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n) + shift * np.eye(n)
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("restart,rtol", [(10, 1e-10), (30, 1e-12),
                                          (5, 1e-8)])
def test_gmres_matches_jax(restart, rtol):
    A, b = _system(80, restart, shift=1.5)
    res_j = jax.jit(lambda bb: j_gmres(lambda x: jnp.asarray(A) @ x, bb,
                                       restart=restart, rtol=rtol,
                                       atol=1e-14, maxiter=500))(
        jnp.asarray(b))
    At = torch.as_tensor(A)
    res_t = gmres(lambda x: At @ x, torch.as_tensor(b), restart=restart,
                  rtol=rtol, atol=1e-14, maxiter=500)
    assert res_t.converged and bool(res_j.converged)
    assert abs(res_t.iters - int(res_j.iters)) <= 1
    x = res_t.x.numpy()
    assert np.linalg.norm(A @ x - b) <= 10 * rtol * np.linalg.norm(b)
    assert np.linalg.norm(x - np.asarray(res_j.x)) <= 1e-8 * np.linalg.norm(x)


def test_gmres_preconditioned_and_x0():
    A, b = _system(50, 7, shift=0.5)
    M = np.diag(1.0 / np.diag(A))
    x0 = np.ones(50)
    At, Mt = torch.as_tensor(A), torch.as_tensor(M)
    res_t = gmres(lambda x: At @ x, torch.as_tensor(b), torch.as_tensor(x0),
                  precond=lambda r: Mt @ r, restart=8, rtol=1e-10,
                  maxiter=400)
    res_j = j_gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                    jnp.asarray(x0), precond=lambda r: jnp.asarray(M) @ r,
                    restart=8, rtol=1e-10, maxiter=400)
    assert res_t.converged == bool(res_j.converged)
    assert abs(res_t.iters - int(res_j.iters)) <= 1
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=1e-7, atol=1e-9)


def test_gmres_singular_breakdown_stalls():
    """A rank-1 operator: the relative breakdown guard and the stall exit
    must stop the solve, unconverged, with a finite x (never NaN/hang)."""
    rng = np.random.default_rng(1)
    u, v = rng.standard_normal(64), rng.standard_normal(64)
    A = np.outer(u, v)
    b = rng.standard_normal(64)
    At = torch.as_tensor(A)
    res_t = gmres(lambda x: At @ x, torch.as_tensor(b), restart=30,
                  rtol=1e-10, maxiter=600)
    res_j = j_gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), restart=30,
                    rtol=1e-10, maxiter=600)
    assert not res_t.converged and not bool(res_j.converged)
    assert np.isfinite(res_t.x.numpy()).all()
    # the breakdown sits at round-off level, so where it is detected may
    # differ by a few iterations; both must stall long before maxiter
    assert res_t.iters < 30 and int(res_j.iters) < 30


def test_gmres_float32_rounds_in_float32():
    A, b = _system(40, 3)
    At = torch.as_tensor(A, dtype=torch.float32)
    res = gmres(lambda x: At @ x, torch.as_tensor(b, dtype=torch.float32),
                restart=20, rtol=1e-5, atol=1e-6)
    assert res.converged and res.x.dtype == torch.float32
    r = A @ res.x.double().numpy() - b
    assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b)


def test_arnoldi_matches_jax():
    A, b = _system(60, 5)
    V_j, H_j = j_arnoldi(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), 12)
    At = torch.as_tensor(A)
    V, H = arnoldi(lambda x: At @ x, torch.as_tensor(b), 12)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_j), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(V.numpy(), np.asarray(V_j), rtol=1e-10,
                               atol=1e-12)
    # the Arnoldi relation A V_m = V_{m+1} H
    np.testing.assert_allclose(A @ V.numpy()[:12].T, V.numpy().T @ H.numpy(),
                               atol=1e-12)


@pytest.mark.parametrize("nb,agg", [(100, 48), (75, 8), (2500, 48)])
def test_restrict_prolong_match_jax(nb, agg):
    """nbp covers both the kernel rounding and the aggregate padding: at
    nb = 100, agg = 48 the aggregates pad to 144 > 128."""
    cs_j = jco.build_aggregates(nb, agg)
    cs = tco.build_aggregates(nb, agg)
    assert (cs.n_agg, cs.nb_pad, cs.nc) == (cs_j.n_agg, cs_j.nb_pad, cs_j.nc)
    nbp = plane_nbp(nb, cs.nb_pad)
    assert nbp >= cs.nb_pad and nbp >= nb and nbp % 128 == 0
    rng = np.random.default_rng(nb)
    r = np.zeros((4, nbp))
    r[:, :nb] = rng.standard_normal((4, nb))
    rc = tco.restrict_planes(cs, torch.as_tensor(r.reshape(-1)), nbp).numpy()
    rc_j = np.asarray(jco.restrict_planes(cs_j, jnp.asarray(r.reshape(-1)),
                                          nbp))
    np.testing.assert_allclose(rc, rc_j, rtol=1e-13, atol=1e-13)
    zc = rng.standard_normal(cs.nc)
    z = tco.prolong_planes(cs, torch.as_tensor(zc), nbp, nb).numpy()
    np.testing.assert_array_equal(
        z, np.asarray(jco.prolong_planes(cs_j, jnp.asarray(zc), nbp, nb)))
    assert np.all(z.reshape(4, nbp)[:, nb:] == 0)
    if cs.nb_pad > 128:       # a layout rounded to the kernel block only
        with pytest.raises(ValueError, match="padding"):
            tco.restrict_planes(cs, torch.zeros(4 * 128), 128)


@pytest.mark.parametrize("nb,agg", [(100, 48), (75, 8), (29, 4)])
def test_interleaved_restrict_prolong_match_jax(nb, agg):
    """The scalar-layout R and P (reshape-sums and broadcasts in the port,
    0/1 mix-matrix products in the JAX package) at rel 1e-13."""
    cs_j = jco.build_aggregates(nb, agg)
    cs = tco.build_aggregates(nb, agg)
    rng = np.random.default_rng(nb + agg)
    r = rng.standard_normal(4 * nb)
    rc = tco.restrict(cs, torch.as_tensor(r)).numpy()
    rc_j = np.asarray(jco.restrict(cs_j, jnp.asarray(r)))
    assert rc.shape == (cs.nc,)
    np.testing.assert_allclose(rc, rc_j, rtol=1e-13, atol=1e-13)
    zc = rng.standard_normal(cs.nc)
    z = tco.prolong(cs, torch.as_tensor(zc)).numpy()
    np.testing.assert_allclose(
        z, np.asarray(jco.prolong(cs_j, jnp.asarray(zc))), rtol=1e-13,
        atol=0)
    # P = R^T: <R r, zc> == <r, P zc>
    assert abs(rc @ zc - r @ z) <= 1e-12 * np.abs(r).sum() * np.abs(zc).max()


@pytest.mark.parametrize("agg", [4, 8])
def test_coarse_operator_dia_matches_jax(agg):
    """coarse_dia_offsets and the sparse Galerkin A_c of the multilevel
    path == JAX at rel 1e-13, with random nonzero fine data also where
    i + d leaves the matrix, and == the dense A_c on the live entries."""
    jd = jas.build_discretization(jbox.channel_mesh(6, 3, 3, obstacle=True),
                                  dtype=jnp.float64)
    offs = jd.dia_pattern.offsets
    rng = np.random.default_rng(agg)
    data = rng.standard_normal((len(offs), jd.ndof))
    c_off = tco.coarse_dia_offsets(offs, agg)
    assert c_off == jco.coarse_dia_offsets(offs, agg)
    cs_j = jco.build_aggregates(jd.nv, agg)
    cs = tco.build_aggregates(jd.nv, agg)
    ac_j = np.asarray(jco.coarse_operator_dia(cs_j, offs, jnp.asarray(data),
                                              c_off, shift=1e-6))
    ac = tco.coarse_operator_dia(cs, offs, torch.as_tensor(data), c_off,
                                 shift=1e-6).numpy()
    assert ac.shape == (len(c_off), cs.nc)
    np.testing.assert_allclose(ac, ac_j, rtol=1e-13, atol=1e-13)
    dense = tco.coarse_dense_matrix(cs, offs, torch.as_tensor(data),
                                    shift=1e-6).numpy()
    from_dia = jdia.ScalarDIA(c_off, jnp.asarray(ac), 0).to_dense()
    np.testing.assert_allclose(from_dia, dense, rtol=1e-13, atol=1e-12)


@pytest.mark.parametrize("agg", [8, 48])
def test_coarse_inverse_matches_jax(agg):
    jm = jbox.channel_mesh(4, 2, 2, obstacle=True)
    jd = jas.build_discretization(jm, dtype=jnp.float64)
    data = np.array(jas.assemble_dia_values(
        jd.tets, jd.vol, jd.grad, jd.h, jnp.zeros((jd.ne, 3, 4)), 1e-3,
        100.0, 0.1, jd.dia_elem_map, terms=jas.LINEAR_TERMS,
        K=jd.dia_pattern.K, ndof=jd.ndof))
    offs = jd.dia_pattern.offsets
    cs_j = jco.build_aggregates(jd.nv, agg)
    cs = tco.build_aggregates(jd.nv, agg)
    ac_j = np.asarray(jco.coarse_dense_matrix(cs_j, offs, jnp.asarray(data),
                                              shift=1e-6))
    ac = tco.coarse_dense_matrix(cs, offs, torch.as_tensor(data),
                                 shift=1e-6).numpy()
    np.testing.assert_allclose(ac, ac_j, rtol=1e-13, atol=1e-15)
    inv_j = np.asarray(jco.coarse_operator_inverse_dia(
        cs_j, offs, jnp.asarray(data), shift=1e-6))
    inv = tco.coarse_operator_inverse_dia(cs, offs, torch.as_tensor(data),
                                          shift=1e-6)
    assert inv.dtype == torch.float64
    np.testing.assert_allclose(inv.numpy(), inv_j, rtol=1e-9,
                               atol=1e-9 * np.abs(inv_j).max())
