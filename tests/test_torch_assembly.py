"""The port's element matrices and DIA assembly against the golden element
data (reference `integration.c`) and against the JAX package, in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.fem import assembly as jas
from navierstokes_tpu.mesh import box as jbox
from navierstokes_tpu.ops.block import block4_inverse as j_inv
from navierstokes_tpu.sparse.dia import diag_blocks_from_dia as j_diag
from navierstokes_tpu.sparse.dia import zero_rows_dia as j_zero_rows
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.fem import elements as el
from navierstokes_tpu_torch.fem.assembly import (
    LINEAR_TERMS,
    STOKES_TERMS,
    assemble_dia_values,
    build_discretization,
)
from navierstokes_tpu_torch.ops.block import block4_inverse
from navierstokes_tpu_torch.sparse.dia import (
    diag_blocks_from_dia,
    zero_rows_dia,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _a(golden_inputs, case):
    return torch.as_tensor(golden_inputs[case]["a"])[None]


@pytest.mark.parametrize("case", ["unit", "skew"])
def test_geometry_golden(golden_elements, golden_inputs, case):
    g = golden_elements[case]
    a = _a(golden_inputs, case)
    np.testing.assert_allclose(el.tet_volume(a)[0], g["vol"], rtol=1e-14)
    np.testing.assert_allclose(el.tet_gradients(a)[0], g["grad"], rtol=1e-13,
                               atol=1e-15)
    np.testing.assert_allclose(el.tet_diameter(a)[0], g["h"], rtol=1e-14)


@pytest.mark.parametrize("case", ["unit", "skew"])
def test_element_matrices_golden(golden_elements, golden_inputs, case):
    g = golden_elements[case]
    inp = golden_inputs[case]
    a = _a(golden_inputs, case)
    vol, grad, h = el.element_geometry(a)
    np.testing.assert_allclose(el.mass_matrix(vol)[0], g["M"], rtol=1e-14,
                               atol=1e-18)
    A0 = el.diffusion_matrix(grad, vol, inp["Re"])[0]
    np.testing.assert_allclose(A0, g["A0"], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(el.divergence_matrix(grad, vol)[0], g["B"],
                               rtol=1e-12, atol=1e-16)
    np.testing.assert_allclose(
        el.pressure_stabilization_matrix(grad, vol, h, inp["delta"])[0],
        g["D"], rtol=1e-12, atol=1e-16)


def test_unknown_element_terms_raise():
    a = torch.eye(4, 3, dtype=torch.float64)[None]
    vol, grad, h = el.element_geometry(a)
    with pytest.raises(NotImplementedError, match="slice 2"):
        el.element_node_blocks(grad, vol, h, 1.0, 1.0, 0.1,
                               terms=frozenset({"convection"}))


@pytest.mark.parametrize("name,terms", [
    ("stokes", STOKES_TERMS),
    ("linear", LINEAR_TERMS),
    ("mass_dt_bare", frozenset({"mass_dt_bare"})),
])
@pytest.mark.parametrize("chunk", [16384, 50])
def test_assemble_dia_values_matches_jax(name, terms, chunk):
    jm = jbox.channel_mesh(4, 2, 2)
    jd = jas.build_discretization(jm, dtype=jnp.float64)
    td = build_discretization(convert.mesh_from_jax(jm), torch.float64, CPU)
    dt, re, delta = 1e-3, 100.0, 0.1
    K, ndof = jd.dia_pattern.K, jd.ndof
    ref = np.asarray(jas.assemble_dia_values(
        jd.tets, jd.vol, jd.grad, jd.h, jnp.zeros((jd.ne, 3, 4)), dt, re,
        delta, jd.dia_elem_map, terms=terms, K=K, ndof=ndof))
    got = assemble_dia_values(td.vol, td.grad, td.h, dt, re, delta,
                              td.dia_elem_map, terms=terms, K=K, ndof=ndof,
                              chunk=chunk).numpy()
    err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert err <= 1e-12, err

    offs = jd.dia_pattern.offsets
    zr = zero_rows_dia(offs, torch.as_tensor(got), td.bc.is_bc).numpy()
    zr_ref = np.asarray(j_zero_rows(offs, jnp.asarray(got), jd.bc.is_bc))
    np.testing.assert_array_equal(zr, zr_ref)

    blocks = diag_blocks_from_dia(offs, torch.as_tensor(got), jd.nv).numpy()
    np.testing.assert_array_equal(
        blocks, np.asarray(j_diag(offs, jnp.asarray(got), jd.nv)))


def test_block4_inverse_matches_jax_float64():
    rng = np.random.default_rng(9)
    blocks = rng.standard_normal((64, 4, 4)) + 4 * np.eye(4)
    blocks[3, 0, 0] = 0.0          # zero pivot: the shift must fire
    got = block4_inverse(torch.as_tensor(blocks), pivot_eps=1e-300,
                         shift=1e-8).numpy()
    ref = np.asarray(j_inv(jnp.asarray(blocks), pivot_eps=1e-300, shift=1e-8))
    ok = np.delete(np.arange(64), 3)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-12, atol=1e-14)
    # the shifted block runs on a 1e-8 pivot, which amplifies the rounding
    # differences of its elimination by up to ~1e8
    assert np.isfinite(got).all()
    err = np.linalg.norm(got[3] - ref[3]) / np.linalg.norm(ref[3])
    assert err < 1e-6, err
    np.testing.assert_allclose(got[ok] @ blocks[ok], np.broadcast_to(
        np.eye(4), (63, 4, 4)), atol=1e-12)


def test_block4_inverse_float32_pivot_eps_rounds_to_zero():
    """JAX compares the pivot with a weakly typed 1e-300, which is 0 in
    float32: no shift fires, a zero pivot gives non-finite values — and
    the port must do the same."""
    rng = np.random.default_rng(10)
    blocks = (rng.standard_normal((8, 4, 4)) + 4 * np.eye(4)).astype(
        np.float32)
    blocks[2, 0, 0] = 0.0
    got = block4_inverse(torch.as_tensor(blocks), pivot_eps=1e-300,
                         shift=1e-8).numpy()
    ref = np.asarray(j_inv(jnp.asarray(blocks), pivot_eps=1e-300, shift=1e-8))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert not np.isfinite(got[2]).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode,warn_only", [(False, False), (True, True)])
def test_fixed_order_scatter_add_restores_the_mode(mode, warn_only):
    """The assembly's scatter-add equals index_add_ and leaves PyTorch's
    deterministic mode as it found it."""
    from navierstokes_tpu_torch.ops.scatter import index_add_fixed_order

    rng = np.random.default_rng(1)
    idx = torch.as_tensor(rng.integers(0, 50, 2000))
    vals = torch.as_tensor(rng.standard_normal(2000))
    torch.use_deterministic_algorithms(mode, warn_only=warn_only)
    try:
        out = index_add_fixed_order(torch.zeros(50, dtype=torch.float64),
                                    idx, vals)
        assert torch.are_deterministic_algorithms_enabled() == mode
        assert torch.is_deterministic_algorithms_warn_only_enabled() == \
            warn_only
    finally:
        torch.use_deterministic_algorithms(False)
    want = torch.zeros(50, dtype=torch.float64).index_add_(0, idx, vals)
    torch.testing.assert_close(out, want, rtol=1e-14, atol=1e-14)
