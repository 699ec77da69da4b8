"""The element terms of the reference Jacobian and the element-wise
residual: the PyTorch package's batched functions against the JAX
package's (vmapped over elements) on seeded random elements at rel 1e-12,
and against the golden element matrices of `tests/data_golden_elements.py`
(generated from the reference `integration.c`) at the bars of
`tests/test_elements.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.fem import elements as jel
from navierstokes_tpu_torch.fem import elements as el

torch.set_num_threads(1)
E = 64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def batch():
    """E seeded random tets (perturbed unit simplices, positive volume)
    with nodal velocities, old velocities and pressures."""
    rng = np.random.default_rng(2026)
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    a = base[None] + 0.08 * rng.standard_normal((E, 4, 3))
    UL = rng.standard_normal((E, 3, 4))
    UL_old = rng.standard_normal((E, 3, 4))
    PL = rng.standard_normal((E, 4))
    jvol, jgrad, jh = jax.vmap(jel.element_geometry)(jnp.asarray(a))
    assert np.all(np.asarray(jvol) > 0)
    tvol, tgrad, th = el.element_geometry(torch.as_tensor(a))
    return dict(a=a, UL=UL, UL_old=UL_old, PL=PL,
                jax=(jgrad, jvol, jh), torch=(tgrad, tvol, th))


def _t(x):
    return torch.as_tensor(x)


_TERMS = {
    "velocity_gradient": lambda m, g, v, h, U: m.velocity_gradient(U, g),
    "convection_matrix_linearized":
        lambda m, g, v, h, U: m.convection_matrix_linearized(U, g, v),
    "convection_matrix_nonlinear":
        lambda m, g, v, h, U: m.convection_matrix_nonlinear(U, g, v),
    "convection_jacobian_a1":
        lambda m, g, v, h, U: m.convection_jacobian(U, g, v)[0],
    "convection_jacobian_a2":
        lambda m, g, v, h, U: m.convection_jacobian(U, g, v)[1],
}


@pytest.mark.parametrize("name", sorted(_TERMS))
def test_convection_terms_match_jax(batch, name):
    fn = _TERMS[name]
    want = jax.vmap(lambda g, v, h, U: fn(jel, g, v, h, U))(
        *batch["jax"], jnp.asarray(batch["UL"]))
    got = fn(el, *batch["torch"], _t(batch["UL"]))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-12


def test_element_residual_matches_jax(batch):
    jg, jv, jh = batch["jax"]
    want_v, want_p = jax.vmap(
        jel.element_residual, in_axes=(0, 0, 0, 0, 0, 0, None, None, None))(
        jg, jv, jh, jnp.asarray(batch["UL"]), jnp.asarray(batch["UL_old"]),
        jnp.asarray(batch["PL"]), 0.01, 300.0, 0.05)
    got_v, got_p = el.element_residual(
        *batch["torch"], _t(batch["UL"]), _t(batch["UL_old"]),
        _t(batch["PL"]), 0.01, 300.0, 0.05)
    assert got_v.shape == (E, 4, 3) and got_p.shape == (E, 4)
    assert _rel(got_v.numpy(), want_v) <= 1e-12
    assert _rel(got_p.numpy(), want_p) <= 1e-12


@pytest.mark.parametrize("terms", [
    frozenset({"convection"}),
    frozenset({"convection_jacobian"}),
    frozenset({"convection", "convection_jacobian"}),
    frozenset({"mass_dt", "diffusion", "convection", "convection_jacobian"}),
], ids=["convection", "convection_jacobian", "nonlinear", "full"])
def test_element_node_blocks_match_jax(batch, terms):
    jg, jv, jh = batch["jax"]
    want = jax.vmap(lambda g, v, h, U: jel.element_node_blocks(
        g, v, h, U, 0.01, 300.0, 0.05, terms=terms))(
        jg, jv, jh, jnp.asarray(batch["UL"]))
    tg, tv, th = batch["torch"]
    got = el.element_node_blocks(tg, tv, th, 0.01, 300.0, 0.05, terms=terms,
                                 UL=_t(batch["UL"]))
    assert got.shape == (E, 4, 4, 4, 4)
    assert _rel(got.numpy(), want) <= 1e-12


def test_convection_terms_need_the_velocities(batch):
    tg, tv, th = batch["torch"]
    with pytest.raises(ValueError, match="UL"):
        el.element_node_blocks(tg, tv, th, 0.01, 1.0, 0.1,
                               terms=frozenset({"convection"}))


def _golden_geometry(golden_inputs, case):
    inp = golden_inputs[case]
    vol, grad, h = el.element_geometry(torch.as_tensor(inp["a"])[None])
    return inp, vol, grad, h, torch.as_tensor(inp["U"])[None]


@pytest.mark.parametrize("case", ["unit", "skew"])
def test_convection_matches_golden(golden_elements, golden_inputs, case):
    """A1 and A2 against the reference `integration.c` (the bar of
    `tests/test_elements.py::test_convection`)."""
    g = golden_elements[case]
    _, vol, grad, _, U = _golden_geometry(golden_inputs, case)
    np.testing.assert_allclose(
        el.convection_matrix_linearized(U, grad, vol)[0], g["A1"],
        rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(
        el.convection_matrix_nonlinear(U, grad, vol)[0], g["A2"],
        rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("case", ["unit", "skew"])
def test_element_residual_matches_golden_matrices(golden_elements,
                                                  golden_inputs, case):
    """The direct-contraction residual against the residual built from the
    golden matrices (the bar of `tests/test_elements.py`)."""
    g = golden_elements[case]
    inp, vol, grad, h, U = _golden_geometry(golden_inputs, case)
    dt, Re, delta = 0.01, inp["Re"], inp["delta"]
    rng = np.random.default_rng(0)
    U_old = rng.standard_normal((3, 4))
    P = rng.standard_normal(4)
    F_v, F_p = el.element_residual(grad, vol, h, U, _t(U_old)[None],
                                   _t(P)[None], dt, Re, delta)
    u = np.asarray(inp["U"]).T.reshape(12)
    u_old = U_old.T.reshape(12)
    M, A0, A1, A2, B, D = (g[k] for k in ("M", "A0", "A1", "A2", "B", "D"))
    fv = (A0 + M / dt) @ u - (M / dt) @ u_old + (A1 + A2) @ u + B.T @ P
    fp = -B @ u + D @ P
    np.testing.assert_allclose(F_v[0].numpy().reshape(-1), fv, rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(F_p[0].numpy(), fp, rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("case", ["unit", "skew"])
def test_full_jacobian_blocks_match_golden(golden_elements, golden_inputs,
                                           case):
    """The velocity block of the full Newton Jacobian's node blocks is
    A0 + M/dt + A1 + A2 + the exact convection Jacobian, with the golden
    A0, M, A1, A2."""
    g = golden_elements[case]
    inp, vol, grad, h, U = _golden_geometry(golden_inputs, case)
    dt = 0.01
    terms = frozenset({"mass_dt", "diffusion", "convection",
                       "convection_jacobian"})
    blocks = el.element_node_blocks(grad, vol, h, dt, inp["Re"], inp["delta"],
                                    terms=terms, UL=U)[0].numpy()
    a1j, a2j = (t[0].numpy() for t in el.convection_jacobian(U, grad, vol))
    want = g["A0"] + g["M"] / dt + g["A1"] + g["A2"] + a1j + a2j
    vv = blocks[:, :, :3, :3].transpose(0, 2, 1, 3).reshape(12, 12)
    np.testing.assert_allclose(vv, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(blocks[:, :, 3, 3], g["D"], rtol=1e-12,
                               atol=1e-16)
