"""The port's scalar-DIA layer (sparse/dia.py, ops/dia.py with kernel K2,
ops/spmv.py) against the JAX package's.

On the CPU the port's wrapper runs K2's plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as the JAX package's own tests
do, and its XLA formulation `spmv_dia`.  Inputs are made with numpy from a
seed and handed to both, in float64.  The kernel itself runs only on the
card (`cuda` marker).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.fem import assembly as jas
from navierstokes_tpu.mesh import box as jbox
from navierstokes_tpu.ops import spmv as jspmv
from navierstokes_tpu.ops.pallas_dia import pretile_dia, spmv_dia_pallas
from navierstokes_tpu.solvers import coarse as jco
from navierstokes_tpu.sparse import bcsr as jbcsr
from navierstokes_tpu.sparse import bell as jbell
from navierstokes_tpu.sparse import dia as jdia
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.ops import cuda_lib
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
    """'oracle', 'ell', 'dia', 'pallas_dia' and 'dia_bf16' give the JAX
    package's answers on the assembled operator."""
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

    # the operator stored in bf16, x and y in f64: the same bf16 values
    # and the same sums in both packages
    y16_j = np.asarray(jspmv.make_spmv("dia_bf16", dia=j_dia)(jnp.asarray(x)))
    y16 = tspmv.make_spmv("dia_bf16", dia=t_dia)(torch.as_tensor(x))
    assert y16.dtype == torch.float64
    assert _rel(y16.numpy(), y16_j) <= 1e-14
    assert 1e-5 < _rel(y16.numpy(), y_ref) <= 2e-2     # the bf16 rounding

    # the block-ELL form of the same blocks: the JAX package's 'ell' and
    # the oracle at rel 1e-13 (f64)
    j_ell = jbell.bell_from_bcsr(jbcsr.BCSR4(jd.indptr, jd.indices,
                                             jnp.asarray(blocks)))
    t_ell = convert.bell_from_jax(j_ell)
    np.testing.assert_array_equal(t_ell.indices, j_ell.indices)
    y_e = tspmv.make_spmv("ell", ell=t_ell)(torch.as_tensor(x))
    y_je = np.asarray(jspmv.make_spmv("ell", ell=j_ell)(jnp.asarray(x)))
    assert _rel(y_e.numpy(), y_je) <= 1e-13
    assert _rel(y_e.numpy(), y_o.numpy()) <= 1e-13
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
    with pytest.raises(TypeError, match="dtype"):
        tdia.spmv_dia(offs, data, x.float())
    # bf16 operator data with an f64 x runs (matvec_dtype); a bf16 x does
    # not: bf16 is a storage dtype of the operator only
    y = tdia.spmv_dia(offs, data.bfloat16(), x)
    assert y.dtype == torch.float64 and y.shape == (64,)
    with pytest.raises(TypeError, match="bfloat16"):
        tdia.spmv_dia(offs, data.bfloat16(), x.bfloat16())
    with pytest.raises(TypeError, match="bfloat16"):
        tdia.spmv_dia(offs, data, x.bfloat16())


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


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("n", [3000, 3001, 3002, 3003])
def test_plain_any_row_count_matches_pallas(jdisc, n, dtype, bar):
    """K2 takes any n: rows need no alignment (n % 4 in {0, 1, 2, 3}).  The
    plain version against spmv_dia_pallas in interpret mode on the same
    numpy inputs, random and nonzero also where i + off leaves the matrix:
    f64 at rel 1e-13, f32 against the f64 answer at rel 1e-6."""
    offsets = jdisc.dia_pattern.offsets
    assert max(abs(d) for d in offsets) < n
    rng = np.random.default_rng(n)
    data = rng.standard_normal((len(offsets), n))
    x = rng.standard_normal(n)
    y_pallas = np.asarray(spmv_dia_pallas(offsets, jnp.asarray(data),
                                          jnp.asarray(x), tile=256,
                                          interpret=True))
    y = tdia.spmv_dia(offsets, torch.as_tensor(data, dtype=dtype),
                      torch.as_tensor(x, dtype=dtype))
    assert y.dtype == dtype and y.shape == (n,)
    assert _rel(y.double().numpy(), y_pallas) <= bar


def _bf16_pair(rng, k: int, n: int):
    """Random operator data rounded to bf16 once (numpy -> JAX -> the
    same 16-bit patterns in torch), nonzero also where i + off leaves the
    matrix."""
    j16 = jnp.asarray(rng.standard_normal((k, n))).astype(jnp.bfloat16)
    return j16, convert._tensor(j16, "cpu")


@pytest.mark.parametrize("x_dtype,bar", [("float32", 1e-6),
                                         ("float64", 1e-14)])
@pytest.mark.parametrize("n", [3000, 3001, 3002, 3003])
def test_bf16_plain_matches_jax_spmv_dia(jdisc, n, x_dtype, bar):
    """K2's bf16 form (matvec_dtype): bf16 operator data, x in f32 or f64,
    the sum in x's dtype.  The plain version against the JAX package's XLA
    `spmv_dia` on the same bf16 data and x, at n % 4 in {0, 1, 2, 3} (the
    kernel reads two rows per thread, paired only where n is even)."""
    offsets = jdisc.dia_pattern.offsets
    rng = np.random.default_rng(100 + n)
    j16, t16 = _bf16_pair(rng, len(offsets), n)
    x = rng.standard_normal(n).astype(x_dtype)
    y_j = np.asarray(jspmv.spmv_dia(offsets, j16, jnp.asarray(x)))
    tdia.reset_counters()
    y = tdia.spmv_dia(offsets, t16, torch.as_tensor(x))
    assert t16.dtype == torch.bfloat16 and tdia.plain_calls == 1
    assert y.dtype == getattr(torch, x_dtype) and y_j.dtype == x.dtype
    assert _rel(y.double().numpy(), y_j.astype(np.float64)) <= bar


@pytest.mark.parametrize("x_dtype,bar", [("float32", 1e-6),
                                         ("float64", 1e-14)])
def test_bf16_plain_matches_windowed_pallas(jdisc, x_dtype, bar):
    """The TPU ran the model's bf16 operator through the windowed Pallas
    form on pretiled data (x kept in its own dtype): run in interpret mode
    as the JAX package's tests run it, it equals the plain version.  (The
    non-windowed form rounds x to bf16 first, a TPU quirk not carried.)"""
    offsets = jdisc.dia_pattern.offsets
    n = jdisc.ndof
    rng = np.random.default_rng(17)
    j16, t16 = _bf16_pair(rng, len(offsets), n)
    x = rng.standard_normal(n).astype(x_dtype)
    y_win = np.asarray(spmv_dia_pallas(
        offsets, pretile_dia(j16, n, tile=256), jnp.asarray(x),
        interpret=True, windowed=True, n=n))
    y = tdia.spmv_dia(offsets, t16, torch.as_tensor(x))
    assert y_win.dtype == x.dtype
    assert _rel(y.double().numpy(), y_win.astype(np.float64)) <= bar


@pytest.mark.cuda
def test_bf16_kernel_matches_plain_on_the_card():
    """K2's bf16 form on the card against its plain version, f32 x at rel
    1e-6 and f64 x at rel 1e-13, at n % 4 in {0, 1, 2, 3} and on a view
    that starts on 2 bytes (the unpaired loads), a second call equal bit
    for bit, each launch counted under its form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 has no CPU or interpret mode")
    from navierstokes_tpu_torch.fem.assembly import build_discretization
    from navierstokes_tpu_torch.mesh import channel_mesh

    offsets = build_discretization(channel_mesh(12, 6, 6), torch.float64,
                                   torch.device("cpu")).dia_pattern.offsets
    rng = np.random.default_rng(23)
    tdia.reset_counters()
    for dtype, bar in ((torch.float32, 1e-6), (torch.float64, 1e-13)):
        for n in (20000, 20001, 20002, 20003, -20000):
            flat = torch.as_tensor(rng.standard_normal(
                len(offsets) * abs(n) + 1)).to(torch.bfloat16).cuda()
            data = (flat[1:] if n < 0 else flat[:-1]).view(len(offsets),
                                                           abs(n))
            x = torch.as_tensor(rng.standard_normal(abs(n)),
                                dtype=dtype).cuda()
            y = tdia.spmv_dia(offsets, data, x)
            torch.cuda.synchronize()
            ref = tdia.spmv_dia_plain(offsets, data, x)
            err = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
            assert y.dtype == dtype and err <= bar, (dtype, n, err)
            assert torch.equal(tdia.spmv_dia(offsets, data, x), y)
    assert tdia.form_launches == {"bfloat16/float32": 10,
                                  "bfloat16/float64": 10}


def test_constants_match_the_source():
    """The wrapper mirrors K2's limit on the diagonals; the kernel's
    parameter block (the offsets by value, beside three pointers and n)
    stays inside the 4 KB a launch may pass."""
    text = (cuda_lib.CSRC / "dia.cu").read_text()
    k2 = {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert k2["kMaxDiagonals"] == tdia.MAX_DIAGONALS
    assert k2["kThreads"] % 32 == 0 and k2["kThreads"] <= 1024
    assert 4 * (k2["kMaxDiagonals"] + 1) + 3 * 8 + 4 <= 4096
    assert '#include "' not in text      # one source, no header to hash
    assert cuda_lib.source_files("dia") == [cuda_lib.CSRC / "dia.cu"]
