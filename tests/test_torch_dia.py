"""The port's scalar-DIA layer (sparse/dia.py, ops/dia.py with kernel K2,
ops/spmv.py) against the JAX package's.

On the CPU the port's wrapper runs K2's plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as the JAX package's own tests
do, and its XLA formulation `spmv_dia`.  Inputs are made with numpy from a
seed and handed to both, in float64.  The kernel itself runs only on the
card (`cuda` marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.fem import assembly as jas
from navierstokes_tpu.mesh import box as jbox
from navierstokes_tpu.ops import spmv as jspmv
from navierstokes_tpu.ops.pallas_dia import spmv_dia_pallas
from navierstokes_tpu.solvers import coarse as jco
from navierstokes_tpu.sparse import dia as jdia
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.ops import dia as tdia
from navierstokes_tpu_torch.ops import spmv as tspmv
from navierstokes_tpu_torch.sparse import dia as tsd

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jdisc():
    """The JAX discretization of a small channel with an obstacle."""
    return jas.build_discretization(jbox.channel_mesh(6, 3, 3, obstacle=True),
                                    dtype=jnp.float64)


def _offset_sets(pattern):
    """The offset sets the scalar-DIA path applies: A, S = D^{-1}A, the
    7-diagonal D^{-1} and a multilevel coarse level."""
    return {
        "A": pattern.offsets,
        "S": pattern.scaled_offsets,
        "Dinv": tuple(range(-3, 4)),
        "coarse": jco.coarse_dia_offsets(pattern.offsets, 4),
    }


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))


@pytest.mark.parametrize("form", ["A", "S", "Dinv", "coarse"])
def test_plain_matches_pallas_and_xla(jdisc, form):
    """K2's plain version == spmv_dia_pallas (interpret) == the XLA
    formulation, f64 at rel 1e-13.  The data is random and nonzero also
    where i + off leaves [0, n): every version must read x as zero there."""
    offsets = _offset_sets(jdisc.dia_pattern)[form]
    n = jdisc.ndof
    assert max(abs(d) for d in offsets) < n
    rng = np.random.default_rng(len(offsets))
    data = rng.standard_normal((len(offsets), n))
    x = rng.standard_normal(n)

    y_xla = np.asarray(jspmv.spmv_dia(offsets, jnp.asarray(data),
                                      jnp.asarray(x)))
    y_pallas = np.asarray(spmv_dia_pallas(offsets, jnp.asarray(data),
                                          jnp.asarray(x), tile=256,
                                          interpret=True))
    tdia.reset_counters()
    y = tdia.spmv_dia(offsets, torch.as_tensor(data), torch.as_tensor(x))
    assert y.dtype == torch.float64 and tdia.plain_calls == 1
    assert _rel(y.numpy(), y_pallas) <= 1e-13
    assert _rel(y.numpy(), y_xla) <= 1e-13
    # and the dense product
    dense = jdia.ScalarDIA(offsets, jnp.asarray(data), 0).to_dense()
    assert _rel(y.numpy(), dense @ x) <= 1e-13


def test_plain_matches_windowed_pallas(jdisc):
    """The windowed TPU variant (x windows DMA'd per tile) computes the
    same function: K2 replaces both."""
    offsets = jdisc.dia_pattern.offsets
    rng = np.random.default_rng(7)
    data = rng.standard_normal((len(offsets), jdisc.ndof))
    x = rng.standard_normal(jdisc.ndof)
    y_win = np.asarray(spmv_dia_pallas(offsets, jnp.asarray(data),
                                       jnp.asarray(x), tile=256,
                                       interpret=True, windowed=True))
    y = tdia.spmv_dia(offsets, torch.as_tensor(data), torch.as_tensor(x))
    assert _rel(y.numpy(), y_win) <= 1e-13


def test_plain_float32_accumulates_in_float32():
    rng = np.random.default_rng(5)
    offsets = (-9, -1, 0, 2, 17)
    data = torch.as_tensor(rng.standard_normal((5, 300)), dtype=torch.float32)
    x = torch.as_tensor(rng.standard_normal(300), dtype=torch.float32)
    y = tdia.spmv_dia(offsets, data, x)
    y64 = tdia.spmv_dia(offsets, data.double(), x.double())
    assert y.dtype == torch.float32
    assert float(torch.linalg.norm(y.double() - y64)
                 / torch.linalg.norm(y64)) < 1e-6


def test_make_spmv_variants_match_jax(jdisc):
    """'oracle', 'dia' and 'pallas_dia' give the JAX package's answers on
    the assembled operator; 'ell' and 'dia_bf16' name their slices."""
    jd = jdisc
    pat = jd.dia_pattern
    data = np.asarray(jas.assemble_dia_values(
        jd.tets, jd.vol, jd.grad, jd.h, jnp.zeros((jd.ne, 3, 4)), 1e-2, 100.0,
        0.1, jd.dia_elem_map, terms=jas.LINEAR_TERMS, K=pat.K, ndof=jd.ndof))
    j_dia = jdia.ScalarDIA(pat.offsets, jnp.asarray(data), pat.nnz)
    t_dia = convert.scalar_dia_from_jax(j_dia)
    assert t_dia.offsets == pat.offsets and t_dia.ndof == j_dia.ndof
    rng = np.random.default_rng(3)
    x = rng.standard_normal(jd.ndof)
    y_ref = np.asarray(jspmv.make_spmv("dia", dia=j_dia)(jnp.asarray(x)))
    for variant in ("dia", "pallas_dia"):
        y = tspmv.make_spmv(variant, dia=t_dia)(torch.as_tensor(x))
        assert _rel(y.numpy(), y_ref) <= 1e-13, variant

    # the BCSR oracle on the same operator's block values (the pattern's
    # flat map sends each block entry to its DIA slot)
    row_ids, indices = jd.row_ids.astype(np.int64), jd.indices.astype(np.int64)
    blocks = data.reshape(-1)[pat.flat_map].reshape(-1, 4, 4)
    y_j = np.asarray(jspmv.spmv_bcsr_ref(jnp.asarray(row_ids),
                                         jnp.asarray(indices),
                                         jnp.asarray(blocks), jnp.asarray(x)))
    bcsr = (torch.as_tensor(row_ids), torch.as_tensor(indices),
            torch.as_tensor(blocks))
    y_o = tspmv.make_spmv("oracle", bcsr=bcsr)(torch.as_tensor(x))
    assert _rel(y_o.numpy(), y_j) <= 1e-13
    assert _rel(y_o.numpy(), y_ref) <= 1e-13

    with pytest.raises(NotImplementedError, match="slice 16"):
        tspmv.make_spmv("ell")
    with pytest.raises(NotImplementedError, match="slice 3"):
        tspmv.make_spmv("dia_bf16", dia=t_dia)
    with pytest.raises(ValueError, match="unknown"):
        tspmv.make_spmv("csr")


def test_scaled_plan_matches_jax(jdisc):
    """The static block-row-scaling plan of the port's pattern build."""
    from navierstokes_tpu_torch.fem.assembly import build_discretization
    from navierstokes_tpu_torch.mesh import channel_mesh

    td = build_discretization(channel_mesh(6, 3, 3, obstacle=True),
                              torch.float64, torch.device("cpu"))
    jp, tp = jdisc.dia_pattern, td.dia_pattern
    assert tp.scaled_offsets == jp.scaled_offsets
    assert tp.scaled_terms == jp.scaled_terms
    assert len(tp.scaled_offsets) > tp.K


def test_scale_rows_and_block_diag_match_jax(jdisc):
    """scale_rows_dia and block_diag_to_dia == JAX at rel 1e-13, with
    random nonzero DIA data (also outside the matrix) and random blocks."""
    pat = jdisc.dia_pattern
    nb = jdisc.nv
    rng = np.random.default_rng(9)
    data = rng.standard_normal((pat.K, jdisc.ndof))
    blocks = rng.standard_normal((nb, 4, 4))

    bd_j = jdia.block_diag_to_dia(jnp.asarray(blocks))
    bd = tsd.block_diag_to_dia(torch.as_tensor(blocks))
    assert bd.offsets == bd_j.offsets == tuple(range(-3, 4))
    np.testing.assert_array_equal(bd.data.numpy(), np.asarray(bd_j.data))
    assert bd.nnz == bd_j.nnz

    s_off_j, s_j = jdia.scale_rows_dia(pat, jnp.asarray(data),
                                       jnp.asarray(blocks))
    s_off, s = tsd.scale_rows_dia(pat, torch.as_tensor(data),
                                  torch.as_tensor(blocks))
    assert s_off == s_off_j
    assert _rel(s.numpy(), s_j) <= 1e-13


def test_cpu_dispatch_counts_plain_only():
    rng = np.random.default_rng(8)
    data = torch.as_tensor(rng.standard_normal((3, 64)))
    x = torch.as_tensor(rng.standard_normal(64))
    tdia.reset_counters()
    tdia.spmv_dia((-1, 0, 1), data, x)
    tdia.spmv_dia_plain((-1, 0, 1), data, x)
    assert tdia.kernel_launches == 0
    assert tdia.plain_calls == 2
    tdia.reset_counters()
    assert tdia.plain_calls == 0


def test_kernel_wrapper_rejects_what_it_cannot_take():
    data = torch.zeros(3, 64, dtype=torch.float64)
    x = torch.zeros(64, dtype=torch.float64)
    offs = (-1, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tdia.spmv_dia_cuda(offs, data, x)
    with pytest.raises(ValueError, match="offsets"):
        tdia.spmv_dia((0, 1), data, x)
    with pytest.raises(ValueError, match="1..256"):
        tdia.spmv_dia(tuple(range(257)), torch.zeros(257, 64), torch.zeros(64))
    with pytest.raises(ValueError, match="shape"):
        tdia.spmv_dia(offs, data, x[:-1])
    with pytest.raises(TypeError, match="dtype"):
        tdia.spmv_dia(offs, data.float(), x)
    with pytest.raises(NotImplementedError, match="slice 3"):
        tdia.spmv_dia(offs, data.bfloat16(), x.bfloat16())


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """K2 against its plain version on the card for the A, S, D^{-1} and
    coarse offset sets of a small channel: f32 at rel 1e-5, f64 at rel
    1e-12, with random data also where i + off leaves the matrix."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 has no CPU or interpret mode")
    from navierstokes_tpu_torch.fem.assembly import build_discretization
    from navierstokes_tpu_torch.mesh import channel_mesh
    from navierstokes_tpu_torch.solvers.coarse import coarse_dia_offsets

    pat = build_discretization(channel_mesh(12, 6, 6), torch.float64,
                               torch.device("cpu")).dia_pattern
    sets = (pat.offsets, pat.scaled_offsets, tuple(range(-3, 4)),
            coarse_dia_offsets(pat.offsets, 4))
    rng = np.random.default_rng(21)
    for dtype, bar in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for offsets in sets:
            data = torch.as_tensor(rng.standard_normal((len(offsets),
                                                        pat.ndof)),
                                   dtype=dtype).cuda()
            x = torch.as_tensor(rng.standard_normal(pat.ndof),
                                dtype=dtype).cuda()
            y = tdia.spmv_dia(offsets, data, x)
            torch.cuda.synchronize()
            ref = tdia.spmv_dia_plain(offsets, data, x)
            err = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
            assert y.dtype == dtype and err <= bar, (dtype, len(offsets), err)
