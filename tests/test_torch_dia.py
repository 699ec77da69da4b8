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
    """The wrapper mirrors K2's limits: the diagonals, the tiled route's
    threads and chunk depth; the parameter block (the offsets by value
    beside three pointers, n, the ghost width and the tile) stays inside
    the 4 KB a launch may pass; one source, no header to hash; the four
    entry points of each route."""
    text = (cuda_lib.CSRC / "dia.cu").read_text()
    k2 = {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert k2["kMaxDiagonals"] == tdia.MAX_DIAGONALS
    assert k2["kThreads"] % 32 == 0 and k2["kThreads"] <= 1024
    assert k2["kMaxThreads"] == tdia.MAX_THREADS
    assert tdia.MAX_THREADS % 32 == 0 and tdia.MAX_THREADS <= 1024
    assert k2["kDepth"] == tdia.DEPTH >= 1
    assert 4 * (k2["kMaxDiagonals"] + 1) + 3 * 8 + 3 * 4 <= 4096
    assert '#include "' not in text      # one source, no header to hash
    assert cuda_lib.source_files("dia") == [cuda_lib.CSRC / "dia.cu"]
    for form in ("f32", "f64", "bf16_f32", "bf16_f64"):
        assert f'extern "C" int dia_spmv_{form}(' in text
        assert f'extern "C" int dia_spmv_tiled_{form}(' in text


# --- the tiled route: what Python decides -----------------------------------

M6_SHARD = 29_376        # rows of one of 4 shards of matrix 6 ('tl' rule)
M6_BJ_SHARD = 29_375     # the same by the 'bj' rule (whole rows): odd
_ITEMSIZE = {"f32": 4, "f64": 8, "bf16": 2}

_PLAN_CASES = [          # (n, data form, SMs)
    (M6_SHARD, "f32", 132), (M6_SHARD, "f64", 132), (M6_SHARD, "bf16", 132),
    (M6_BJ_SHARD, "f32", 132), (M6_BJ_SHARD, "f64", 132),
    (117_500, "f32", 132), (117_500, "bf16", 132),   # n % 8 = 4
    (117_502, "bf16", 132),                          # n % 4 = 2
    (14_784, "f32", 132),                            # one of 8 shards
    (127_776, "f64", 132),                           # one of 4 of matrix 8
    (511_024, "bf16", 132),
    (3_000, "f64", 5),
    (100, "f32", 132),                               # fewer rows than a warp
]


@pytest.mark.parametrize("n,form,n_sm", _PLAN_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in _PLAN_CASES])
def test_tile_plan_covers_every_row_once(n, form, n_sm):
    """Tiles of whole warps of rows cover [0, n) exactly once, in whole
    waves of `n_sm` blocks; threads are whole warps, at most MAX_THREADS,
    one row each (a pair for bf16 data).  No plan asks for an alignment of
    the rows: loads are of one row or one pair, so n % 4 != 0 and odd
    shards (the 'bj' rule) take the route in f32 and f64."""
    size = _ITEMSIZE[form]
    rows = 2 if size == 2 else 1
    plan = tdia.tile_plan(n, size, n_sm)
    assert plan is not None
    assert plan.tn % 32 == 0 and plan.tn % rows == 0
    assert plan.threads == -(-plan.tn // (32 * rows)) * 32
    assert plan.threads <= tdia.MAX_THREADS
    assert (plan.n_tiles - 1) * plan.tn < n <= plan.n_tiles * plan.tn
    waves = -(-plan.n_tiles // n_sm)
    assert plan.tn <= max(32, -(-n // (n_sm * waves)) + 31)
    covered = np.zeros(n, dtype=int)
    for tile in range(plan.n_tiles):
        covered[tile * plan.tn:(tile + 1) * plan.tn] += 1
    assert np.all(covered == 1)


def test_odd_bf16_has_no_plan():
    """bf16 data with an odd n (a 'bj' shard of matrix 6) has no tiled plan:
    a row pair is one 4-byte load; f32 and f64 take any n."""
    assert tdia.tile_plan(M6_BJ_SHARD, 2) is None
    assert tdia.tile_plan(M6_BJ_SHARD, 4) is not None
    assert tdia.tile_plan(M6_BJ_SHARD, 8) is not None


def test_shard_plan_fills_every_sm():
    """A shard of matrix 6 (29,376 rows in 4) takes 132 tiles of 224 rows
    in every data form, one wave on 132 SMs (the 'rows' route: 115 blocks
    of 256 threads on 132 SMs)."""
    for form, size in _ITEMSIZE.items():
        plan = tdia.tile_plan(M6_SHARD, size, 132)
        assert (plan.tn, plan.n_tiles) == (224, 132), form
        assert plan.threads == (128 if size == 2 else 224)
    assert -(-M6_SHARD // 256) == 115


def test_plan_text_names_the_plan():
    plan = tdia.tile_plan(M6_SHARD, 4, 132)
    assert tdia.plan_text(plan) == (
        f"tile 224, 132 tiles of 224 threads, chunks of {tdia.DEPTH} "
        "diagonals")


_A_LIKE = tuple(range(-40, 41))          # 81 diagonals
_ROUTE_CASES = {
    # case: (n, data dtype, x dtype, ghost rows, the route)
    "masked_f32_shard": (M6_SHARD, "f32", "f32", False, "rows"),
    "masked_f64_whole": (117_500, "f64", "f64", False, "rows"),
    "masked_bf16_whole": (117_500, "bf16", "f32", False, "tiled"),
    "masked_bf16_f64_whole": (117_500, "bf16", "f64", False, "rows"),
    "ghost_f32_shard": (M6_SHARD, "f32", "f32", True, "tiled"),
    "ghost_f64_odd_shard": (M6_BJ_SHARD, "f64", "f64", True, "tiled"),
    "ghost_f32_8_shards": (14_784, "f32", "f32", True, "tiled"),
    "ghost_bf16_f64_shard": (M6_SHARD, "bf16", "f64", True, "tiled"),
    "ghost_bf16_odd_shard": (M6_BJ_SHARD, "bf16", "f32", True, "rows"),
    "ghost_f32_matrix8_shard": (127_776, "f32", "f32", True, "rows"),
    "ghost_bf16_matrix8_shard": (127_872, "bf16", "f32", True, "rows"),
    "ghost_one_wave": (132 * 256, "f64", "f64", True, "tiled"),
    "ghost_past_one_wave": (132 * 256 + 1, "f64", "f64", True, "rows"),
    "bf16_two_waves": (132 * 896, "bf16", "f32", False, "tiled"),
    "bf16_past_two_waves": (132 * 896 + 2, "bf16", "f32", False, "rows"),
    "bf16_off_4": (2_000, "bf16", "f32", False, "rows"),
}
_DTYPE = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


@pytest.mark.parametrize("case", list(_ROUTE_CASES))
def test_route_rule(case):
    """`dia_route` names 'tiled' exactly where its docstring says: bf16
    data with f32 x at up to TILED_BF16_MAX_PER_SM threads per SM (matrix
    6's whole vector), any data with ghost rows at up to TILED_MAX_PER_SM
    (a shard of matrix 6 in 4 or 8), where `tiled_plan` has a plan; 'rows'
    for every masked f32/f64 form, a shard of matrix 8, bf16 data with f64
    x on the whole vector, an odd n or data off 4 bytes with bf16.  (Shapes
    only: the data is a broadcast zero, x zeros.)"""
    n, dd, xd, ghosts, want = _ROUTE_CASES[case]
    ddt, xdt = _DTYPE[dd], _DTYPE[xd]
    halo = 2607 if ghosts else 0
    flat = torch.zeros(n + 1, dtype=ddt)
    row = flat[1:] if case == "bf16_off_4" else flat[:-1]
    data = row.expand(len(_A_LIKE), n)
    x = torch.zeros(n + 2 * halo, dtype=xdt)
    plan = tdia.tiled_plan(data, 132)
    assert (plan is None) == (case in ("ghost_bf16_odd_shard", "bf16_off_4"))
    assert tdia.dia_route(data, x, 132, halo) == want
    if case == "bf16_off_4":        # the shape fits, the address not
        assert data.data_ptr() % 4 and tdia.tile_plan(n, 2) is not None


def _chunk_order(k: int, p: int) -> list:
    """The order in which the tiled kernel sums a row's diagonals: its loop
    over whole chunks of p, two a turn, then the tail one at a time
    (`dia_spmv_tiled_kernel`, written out)."""
    order = []
    full = k // p * p
    c = 0
    if full > 0:
        held = list(range(0, p))                  # load(a, 0)
        while c + 2 * p <= full:
            nxt = list(range(c + p, c + 2 * p))   # load(b, c + p)
            order += held                         # sum(a)
            if c + 2 * p < full:
                held = list(range(c + 2 * p, c + 3 * p))
            order += nxt                          # sum(b)
            c += 2 * p
        if c < full:
            order += held
            c += p
    order += list(range(c, k))
    return order


@pytest.mark.parametrize("k", [1, 7, 15, 16, 17, 31, 32, 33, 47, 48, 49,
                               64, 65, 81, 123, 256])
def test_chunks_sum_every_diagonal_once_in_order(k):
    """The tiled kernel's chunk loop (two chunks of DEPTH a turn, the next
    chunk's loads issued before the held one is summed, then the tail)
    sums diagonals 0 .. k - 1 once each, in order: the same sum, bit for
    bit, as the 'rows' kernels' loop over k."""
    assert _chunk_order(k, tdia.DEPTH) == list(range(k))


def _tiled_emulation(offsets, data, x, n_sm, halo=0):
    """K2's tiled route in plain torch: its tiles, and in each its rows'
    terms in the kernel's chunk order, x zero outside [0, n) (or read from
    the ghost rows)."""
    k, n = data.shape
    plan = tdia.tile_plan(n, data.element_size(), n_sm)
    order = _chunk_order(k, tdia.DEPTH)
    xa = x.to(torch.promote_types(x.dtype, torch.float32))
    y = torch.full((n,), float("nan"), dtype=x.dtype)
    for tile in range(plan.n_tiles):
        i0 = tile * plan.tn
        rows = torch.arange(i0, min(i0 + plan.tn, n))
        acc = torch.zeros(len(rows), dtype=x.dtype)
        for kk in order:
            src = rows + offsets[kk]
            inside = (src >= -halo) & (src < n + halo)
            xv = torch.zeros(len(rows), dtype=x.dtype)
            xv[inside] = xa[halo + src[inside]]
            acc = acc + data[kk, rows].to(x.dtype) * xv
        assert torch.isnan(y[rows]).all()          # written once
        y[rows] = acc
    assert not torch.isnan(y).any()
    return y, plan


_EMULATION_CASES = [
    # (offsets, n, n_sm, ghost rows)
    ("A", 448, 132, False),     # 14 tiles of 32 rows
    ("A", 2_500, 1, False),     # one block's worth of SMs: tiles of 256
    ("S", 448, 132, False),
    ("A", 1_000, 4, True),      # a shard's form
    ("S", 3_001, 1, True),      # odd n ('bj' rule) in f32/f64
    ("Dinv", 450, 132, False),
    ("coarse", 448, 5, False),
]
_FORMS = {"f32": (torch.float32, torch.float32),
          "f64": (torch.float64, torch.float64),
          "bf16_f32": (torch.bfloat16, torch.float32),
          "bf16_f64": (torch.bfloat16, torch.float64)}
# bf16 data with an odd n takes the 'rows' route: no plan to emulate
_EMULATION_PARAMS = [(form,) + c for c in _EMULATION_CASES for form in _FORMS
                     if not (form.startswith("bf16") and c[1] % 2)]


@pytest.mark.parametrize(
    "form,offsets,n,n_sm,ghosts", _EMULATION_PARAMS,
    ids=[f"{c[1]}-{c[2]}-{c[3]}" + ("-ghost" if c[4] else "") + f"-{c[0]}"
         for c in _EMULATION_PARAMS])
def test_tiled_emulation_matches_plain_and_pallas(jdisc, form, offsets, n,
                                                  n_sm, ghosts):
    """The tiled route's tiles and chunk order, emulated in plain torch,
    equal the plain version bit for bit (the same products and sums in
    the same order: zeros outside the matrix add nothing) and, in f64,
    spmv_dia_pallas in interpret mode on the same numpy inputs (rel 1e-12;
    masked and with ghost rows, x_prehalo=True).  The data is random and
    nonzero where i + off leaves the matrix; ghost rows are random too."""
    offs = _offset_sets(jdisc.dia_pattern)[offsets]
    ddt, xdt = _FORMS[form]
    rng = np.random.default_rng(len(offs) * n + n_sm)
    h = max(abs(d) for d in offs) if ghosts else 0
    d_np = rng.standard_normal((len(offs), n))
    x_np = rng.standard_normal(n + 2 * h)
    data = torch.as_tensor(d_np).to(ddt)
    x = torch.as_tensor(x_np).to(xdt)
    y, plan = _tiled_emulation(offs, data, x, n_sm, halo=h)
    assert plan.n_tiles >= 2
    assert torch.equal(y, tdia.spmv_dia_plain(offs, data, x, halo=h))
    if form == "f64":
        if ghosts:
            want = spmv_dia_pallas(offs, pretile_dia(jnp.asarray(d_np), n,
                                                     tile=256),
                                   jnp.asarray(x_np), n=n, x_prehalo=True,
                                   interpret=True)
        else:
            want = spmv_dia_pallas(offs, jnp.asarray(d_np),
                                   jnp.asarray(x_np), tile=256,
                                   interpret=True)
        assert _rel(y.numpy(), np.asarray(want)) <= 1e-12


def test_bf16_ghost_rows_with_float32_x_match_pallas(jdisc):
    """The plain ghost-row form on bf16 data with an f32 x against the JAX
    package's spmv_dia_pallas on pretiled data with x_prehalo=True in
    interpret mode (x kept in f32, the sum in f32): rel 1e-6."""
    offs = jdisc.dia_pattern.offsets
    n = 1_000
    h = max(abs(d) for d in offs)
    rng = np.random.default_rng(31)
    j16, t16 = _bf16_pair(rng, len(offs), n)
    x = rng.standard_normal(n + 2 * h).astype(np.float32)
    want = np.asarray(spmv_dia_pallas(offs, pretile_dia(j16, n, tile=256),
                                      jnp.asarray(x), n=n, x_prehalo=True,
                                      interpret=True))
    tdia.reset_counters()
    got = tdia.spmv_dia(offs, t16, torch.as_tensor(x), halo=h)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tdia.plain_calls == 1 and tdia.kernel_launches == 0
    assert _rel(got.double().numpy(), want.astype(np.float64)) <= 1e-6


def test_route_counters_and_cpu_tensors():
    """Launches are counted per route; a CPU tensor never reaches a CUDA
    route, whichever is asked for, and an unknown route is refused."""
    assert set(tdia.route_launches) == set(tdia.ROUTES) == {"tiled", "rows"}
    data = torch.zeros(7, 64, dtype=torch.float64)
    x = torch.zeros(64, dtype=torch.float64)
    offs = tuple(range(-3, 4))
    tdia.reset_counters()
    tdia.spmv_dia(offs, data, x)
    for route in tdia.ROUTES + (None,):
        with pytest.raises(ValueError, match="CUDA"):
            tdia.spmv_dia_cuda(offs, data, x, route=route)
    assert tdia.plain_calls == 1 and tdia.kernel_launches == 0
    assert tdia.route_launches == {"tiled": 0, "rows": 0}


@pytest.mark.cuda
def test_routes_match_plain_and_each_other_on_the_card():
    """Both routes of K2 on the card, masked, with ghost rows and on bf16
    data (f32 and f64 x), A, S and D^{-1} offset sets of a small channel:
    equal to each other bit for bit and within the plain version's bars
    (f32 x rel 1e-5, f64 1e-12), each launch counted under its route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 has no CPU or interpret mode")
    from navierstokes_tpu_torch.fem.assembly import build_discretization
    from navierstokes_tpu_torch.mesh import channel_mesh

    pat = build_discretization(channel_mesh(12, 6, 6), torch.float64,
                               torch.device("cpu")).dia_pattern
    sets = (pat.offsets, pat.scaled_offsets, tuple(range(-3, 4)))
    rng = np.random.default_rng(29)
    tdia.reset_counters()
    launches = 0
    for ddt, xdt, bar in ((torch.float32, torch.float32, 1e-5),
                          (torch.float64, torch.float64, 1e-12),
                          (torch.bfloat16, torch.float32, 1e-5),
                          (torch.bfloat16, torch.float64, 1e-12)):
        for offsets in sets:
            for n, halo in ((pat.ndof, 0), (20_000, 0),
                            (4_000, max(map(abs, offsets)))):
                data = torch.as_tensor(rng.standard_normal(
                    (len(offsets), n))).to(ddt).cuda()
                x = torch.as_tensor(rng.standard_normal(
                    n + 2 * halo)).to(xdt).cuda()
                ys = {r: tdia.spmv_dia_cuda(offsets, data, x, halo=halo,
                                            route=r) for r in tdia.ROUTES}
                torch.cuda.synchronize()
                launches += 1
                ref = tdia.spmv_dia_plain(offsets, data, x, halo=halo)
                err = float(torch.linalg.norm(ys["tiled"] - ref)
                            / torch.linalg.norm(ref))
                assert err <= bar, (ddt, xdt, len(offsets), n, halo, err)
                assert torch.equal(ys["tiled"], ys["rows"])
    assert tdia.route_launches == {"tiled": launches, "rows": launches}
