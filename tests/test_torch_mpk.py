"""The port's matrix powers (ops/mpk.py), the fused A^p x (ops/mpk_fused.py,
kernel K4) and the SpMV / matrix-powers benchmark entry point
(bench/spmv_bench.py) against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions; the JAX side
runs the Pallas kernel in interpret mode on its overlap-tiled operator, as
the JAX package's own tests do.  Inputs are made with numpy from a seed, in
float64.  The kernel itself runs only on the card (`cuda` marker).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.fem.assembly import (
    LINEAR_TERMS,
    assemble_operator,
    build_discretization,
)
from navierstokes_tpu.fem.dirichlet import zero_rows_bcsr
from navierstokes_tpu.mesh import channel_mesh
from navierstokes_tpu.ops import mpk as jmpk
from navierstokes_tpu.ops.mpk_pallas import (
    pretile_dia_overlap,
    spmpv_dia_pallas,
)
from navierstokes_tpu.ops.spmv import spmv_dia as j_spmv_dia
from navierstokes_tpu.sparse.bcsr import BCSR4
from navierstokes_tpu.sparse.dia import dia_from_bcsr
from navierstokes_tpu_torch.bench import spmv_bench
from navierstokes_tpu_torch.bench.timing import rel_error
from navierstokes_tpu_torch.fem.assembly import build_discretization as \
    t_build_discretization
from navierstokes_tpu_torch.mesh.box import scaling_series_mesh
from navierstokes_tpu_torch.ops import cuda_lib, grid_sync, mpk_fused
from navierstokes_tpu_torch.ops import dia as tdia
from navierstokes_tpu_torch.ops import mpk as tmpk
from navierstokes_tpu_torch.ops.band_ring import SMEM_LIMIT

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def system():
    """The channel(3,2,2) operator of the JAX package's tests/test_mpk.py:
    (offsets, data as numpy, n)."""
    mesh = channel_mesh(3, 2, 2, length=2.0)
    disc = build_discretization(mesh, dtype=jnp.float64)
    op = assemble_operator(disc, jnp.zeros(disc.ndof), 0.01, 50.0, 0.1,
                           LINEAR_TERMS)
    values = zero_rows_bcsr(
        op.values, disc.row_ids, jnp.asarray(disc.indices), disc.diag_slots,
        disc.bc.row_bc)
    dia = dia_from_bcsr(BCSR4(indptr=op.indptr, indices=op.indices,
                              values=values))
    return tuple(dia.offsets), np.array(dia.data), disc.ndof


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))


@pytest.mark.parametrize("power", [2, 3, 4])
@pytest.mark.parametrize("tile", [128, 256])
def test_plain_matches_jax_fused_kernel(system, power, tile):
    """spmpv_dia_plain == the JAX fused kernel (interpret mode, overlap-tiled
    operator) at rel 1e-12; the port takes the plain (K, n) data."""
    offsets, data, n = system
    x = np.random.default_rng(power).standard_normal(n)
    h = mpk_fused.halo(offsets)
    dov = pretile_dia_overlap(jnp.asarray(data), n, tile=tile,
                              halo=(power - 1) * h)
    z_j = spmpv_dia_pallas(offsets, dov, jnp.asarray(x), n=n, power=power,
                           tile=tile, interpret=True)
    mpk_fused.reset_counters()
    z = mpk_fused.spmpv_dia(offsets, torch.as_tensor(data),
                            torch.as_tensor(x), power=power)
    assert mpk_fused.plain_calls == 1 and mpk_fused.kernel_launches == 0
    assert z.dtype == torch.float64 and z.shape == (n,)
    assert _rel(z.numpy(), z_j) <= 1e-12


@pytest.mark.parametrize("power", [2, 3, 4])
def test_plain_masks_out_of_range_entries(power):
    """DIA data with random nonzeros where i + off leaves [0, n) (as
    scale_rows_dia and coarse_operator_dia leave them): the fused plain
    version equals p chained K2 plain applies bit for bit, and the JAX
    package's chained XLA SpMV at rel 1e-12."""
    rng = np.random.default_rng(10 + power)
    n = 300
    offsets = (-41, -7, -1, 0, 1, 7, 41)
    data = rng.standard_normal((len(offsets), n))
    x = rng.standard_normal(n)
    dt, xt = torch.as_tensor(data), torch.as_tensor(x)
    z = mpk_fused.spmpv_dia_plain(offsets, dt, xt, power=power)
    chained, zj = xt, jnp.asarray(x)
    for _ in range(power):
        chained = tdia.spmv_dia_plain(offsets, dt, chained)
        zj = j_spmv_dia(offsets, jnp.asarray(data), zj)
    assert torch.equal(z, chained)
    assert _rel(z.numpy(), zj) <= 1e-12


def test_matrix_powers_match_jax(system):
    """matrix_power, matrix_powers_all and krylov_basis (plain and
    normalized) over K2's plain version == the JAX package's at rel
    1e-12."""
    offsets, data, n = system
    rng = np.random.default_rng(5)
    x = rng.standard_normal(n)
    dj, xj = jnp.asarray(data), jnp.asarray(x)
    dt, xt = torch.as_tensor(data), torch.as_tensor(x)
    tdia.reset_counters()
    for k in (1, 3):
        assert _rel(tmpk.matrix_power(offsets, dt, xt, k).numpy(),
                    jmpk.matrix_power(offsets, dj, xj, k)) <= 1e-12
    Y = tmpk.matrix_powers_all(offsets, dt, xt, 3)
    assert Y.shape == (n, 3)
    assert _rel(Y.numpy(), jmpk.matrix_powers_all(offsets, dj, xj, 3)) \
        <= 1e-12
    for normalize in (False, True):
        B = tmpk.krylov_basis(offsets, dt, xt, 4, normalize=normalize)
        assert B.shape == (n, 5)
        assert _rel(B.numpy(), jmpk.krylov_basis(offsets, dj, xj, 4,
                                                 normalize=normalize)) <= 1e-12
    assert tdia.plain_calls == 1 + 3 + 3 + 4 + 4 and tdia.kernel_launches == 0


def test_passes_over_a_counts_the_rereads():
    """The benchmark's model of K4's reads of A: the resident diagonals
    once, the rest in every pass; p (chained SpMVs) with none resident, 1
    (the bound) with all.  At matrix 6 (81 diagonals, 58 resident in f32,
    25 in f64) far below the 7.75-38 passes of overlapping row tiles."""
    assert mpk_fused.passes_over_a(81, 81, 4) == 1.0
    for p in (2, 3, 4):
        assert mpk_fused.passes_over_a(81, 0, p) == p
    assert mpk_fused.passes_over_a(81, 58, 2) == (58 + 2 * 23) / 81
    assert mpk_fused.passes_over_a(81, 25, 4) == (25 + 4 * 56) / 81


@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_fits_the_opt_in(itemsize):
    """K4's plan: the mbarriers, the source window (the slab and the
    offsets' span, where that takes at most half the opt-in) and the
    resident diagonals' slabs fit the 227 KB opt-in for every K <= 256, as
    many diagonals as fit are resident, and the plan holds for a grid of
    more blocks (shorter slabs).  Matrix 6 (n = 117,500, 81 diagonals
    spanning +-2,607, slabs of 892 rows) keeps a window of 6,106 values
    and 58 diagonals in f32, 25 in f64; a span of 40,000 gets no window."""
    half = (SMEM_LIMIT - mpk_fused.HEADER_BYTES) // 2
    for n in (300, 117_500, 511_024, 2_345_678):
        for span in (0, 5_214, 12_000, 40_000):
            for k in range(1, 257):
                pl = mpk_fused.plan(n, k, itemsize, span=span)
                row = pl.ld * itemsize
                wbytes = -(-pl.window * itemsize // 16) * 16
                assert pl.window in (0, pl.ld + span)
                fits = -(-(pl.ld + span) * itemsize // 16) * 16 <= half
                assert (pl.window > 0) == fits
                assert pl.smem == (mpk_fused.HEADER_BYTES + wbytes
                                   + pl.resident * row)
                assert pl.smem <= SMEM_LIMIT
                assert pl.resident == k or pl.smem + row > SMEM_LIMIT
                assert grid_sync.max_slab(n, 4 * mpk_fused.N_SM,
                                          itemsize) <= pl.ld
    pl = mpk_fused.plan(117_500, 81, itemsize, span=5_214)
    assert (pl.ld, pl.window) == (892, 6_106)
    assert pl.resident == {4: 58, 8: 25}[itemsize]
    assert mpk_fused.plan(50_000, 5, itemsize, span=40_000).window == 0


def test_one_cooperative_launch_per_apply():
    """csrc/mpk.cu makes one cooperative launch per A^p x (and one for the
    empty kernel that measures the floor), no plain launch; the constants
    the wrapper mirrors match the source."""
    src = (cuda_lib.CSRC / "mpk.cu").read_text()
    assert "<<<" not in src
    body = src[src.index("int launch(const void* data"):
               src.index("int blocks_per_sm(")]
    assert body.count("grid_sync::launch(") == 1
    assert src.count("grid_sync::launch(") == 2
    assert f"constexpr int kHeaderBytes = {mpk_fused.HEADER_BYTES};" in src
    assert "constexpr int kMaxPower = 4;" in src and max(mpk_fused.POWERS) == 4
    assert cuda_lib.CSRC / "grid_sync.cuh" in cuda_lib.source_files("mpk")


def test_wrapper_rejects_what_it_cannot_take(system):
    offsets, data, n = system
    dt, xt = torch.as_tensor(data), torch.as_tensor(np.ones(n))
    with pytest.raises(ValueError, match="CUDA"):
        mpk_fused.spmpv_dia_cuda(offsets, dt, xt, power=2)
    with pytest.raises(ValueError, match="power"):
        mpk_fused.spmpv_dia(offsets, dt, xt, power=5)
    with pytest.raises(ValueError, match="shape"):
        mpk_fused.spm2v_dia(offsets, dt, xt[:-1])


_LINE = re.compile(r"^(SpMV|SpM2V|SpM3V|SpM4V) (.+?) : +([0-9.]+) us \| "
                   r"(ref|[0-9.]+x) \| (ref|rel err = ([0-9.e+-]+)) \| +"
                   r"[0-9.]+ MB \([0-9.]+x nnz\)$")


def test_bench_main_on_the_cpu(capsys):
    """`bench.spmv_bench.main` at matrix 1, float64, on the CPU: the JAX
    bench's line format, every variant (the BCSR oracle and the block-ELL
    gather, K2, K1 on the plane layout, the fused K4 for spm2v/spm3v/spm4v)
    within rel 1e-12 of the chained plain reference, K2's bf16 form within
    the bf16 rounding of the operator (rel 2e-2, the JAX package's bar for
    its bf16 operator)."""
    mpk_fused.reset_counters()
    rows = spmv_bench.main(["--matrices", "1", "--kernel",
                            "spmv,spm2v,spm3v,spm4v", "--dtype", "float64",
                            "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Matrix loaded: 252 rows, ")
    timed = [ln for ln in out if _LINE.match(ln)]
    assert len(timed) == len(rows) == 4 * 6 + 3
    assert not any("not ported" in ln or "skipped" in ln for ln in out)
    for name in spmv_bench.BLOCK_VARIANTS:
        assert [r["kernel"] for r in rows if r["name"] == name] == [
            "spmv", "spm2v", "spm3v", "spm4v"]
    fused = [r for r in rows if "FUSED K4" in r["name"]]
    assert [r["kernel"] for r in fused] == ["spm2v", "spm3v", "spm4v"]
    assert sum(r["name"] == "DIA bf16 K2" for r in rows) == 4
    assert mpk_fused.plain_calls > 0
    for r in rows:
        assert r["matrix"] == 1 and r["us"] > 0
        if r["name"].startswith("DIA plain"):
            assert r["rel_err"] is None
        elif r["name"] == "DIA bf16 K2":
            assert 1e-5 < r["rel_err"] <= 2e-2
        else:
            assert r["rel_err"] <= 1e-12


def test_bench_block_variants_skip_above_the_cut(monkeypatch, capsys):
    """Above `BLOCK_ROWS_MAX` rows (lowered here to 100 for matrix 1's
    252) the oracle and block-ELL variants are not timed, and one line per
    kernel says so."""
    monkeypatch.setattr(spmv_bench, "BLOCK_ROWS_MAX", 100)
    rows = spmv_bench.main(["--matrices", "1", "--kernel", "spmv",
                            "--dtype", "float64", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == ("SpMV oracle (segment-sum), block-ELL gather : "
                      "skipped above 100 rows (252)")
    assert len(rows) == 4
    assert not {r["name"] for r in rows} & set(spmv_bench.BLOCK_VARIANTS)


def test_bench_ortho_hook_on_the_cpu():
    """2SpMV with the CGS2 hook between the chained applies, on every
    layout (the block-format variants included): the plane variant
    projects against the basis in its own layout and maps back to the
    reference at rel 1e-12 (K2's bf16 form within the bf16 rounding of
    the operator)."""
    rows = spmv_bench.main(["--matrices", "1", "--kernel", "2spmv",
                            "--ortho", "--dtype", "float64", "--device",
                            "cpu"])
    assert len(rows) == 6 and rows[0]["rel_err"] is None
    for r in rows[1:]:
        bar = 2e-2 if r["name"] == "DIA bf16 K2" else 1e-12
        assert r["rel_err"] <= bar, r


def test_bench_flags_outside_the_slice_and_rel_error(tmp_path):
    """`--disc-cache` (slice 8) runs: the first run saves matrix 1's
    discretization under <dir>/m1, the second loads it and gives the same
    errors; and `rel_error`."""
    argv = ["--matrices", "1", "--disc-cache", str(tmp_path), "--dtype",
            "float64", "--device", "cpu"]
    first = spmv_bench.main(argv)
    assert sorted(os.listdir(tmp_path)) == ["m1"]
    second = spmv_bench.main(argv)
    assert [r["rel_err"] for r in second] == [r["rel_err"] for r in first]
    assert rel_error([3.0, 4.0], [3.0, 4.0]) == 0.0
    assert rel_error([3.0, 5.0], [3.0, 4.0]) == pytest.approx(0.2)
    assert np.isnan(rel_error(np.ones(3), np.zeros(3)))


def _card_chain_check(offsets, data, x, repeats):
    """K4 for p = 2, 3, 4 equal bit for bit to p chained K2 launches, over
    `repeats` calls, and within the dtype's bar of the plain version."""
    bar = {torch.float32: 1e-5, torch.float64: 1e-12}[data.dtype]
    for p in mpk_fused.POWERS:
        chained = tmpk.matrix_power(offsets, data, x, p)
        ref = mpk_fused.spmpv_dia_plain(offsets, data, x, power=p)
        for _ in range(repeats):
            z = mpk_fused.spmpv_dia(offsets, data, x, power=p)
            assert torch.equal(z, chained), (data.dtype, p)
        err = float(torch.linalg.norm(z - ref) / torch.linalg.norm(ref))
        assert err <= bar, (data.dtype, p, err)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(system):
    """K4 against p chained K2 launches (bit for bit) and its plain version
    (f32 at rel 1e-5, f64 at rel 1e-12) on the card, with nonzero data at
    the out-of-range entries: n = 20,011 (no bulk copies) with offsets up
    to 300, offsets of +-6000 (a halo too wide for overlapping row tiles
    in shared memory) and of +-20,000 (a span too wide for the source
    window in shared memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU or interpret mode")
    rng = np.random.default_rng(12)
    for offsets, n in (((-300, -41, -1, 0, 1, 41, 300), 20_011),
                       ((-6000, -2607, -1, 0, 1, 2607, 6000), 40_000),
                       ((-20_000, -1, 0, 1, 20_000), 50_000)):
        data = rng.standard_normal((len(offsets), n)) / 3
        x = rng.standard_normal(n)
        for dtype in (torch.float32, torch.float64):
            _card_chain_check(
                offsets, torch.as_tensor(data, dtype=dtype).cuda(),
                torch.as_tensor(x, dtype=dtype).cuda(), repeats=50)


@pytest.mark.cuda
def test_kernel_equals_chained_k2_at_matrix_6_on_the_card():
    """At matrix 6's shapes (n = 117,500, its 81 offsets, random data that
    is nonzero outside the matrix) K4 equals p chained K2 launches bit for
    bit in f32 and f64, in each of 50 calls: the previous pass's y, which
    other blocks wrote before the grid barrier, is never read stale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU or interpret mode")
    disc = t_build_discretization(scaling_series_mesh(6), torch.float64,
                                  torch.device("cpu"))
    offsets = disc.dia_pattern.offsets
    n = disc.ndof
    rng = np.random.default_rng(15)
    data = rng.standard_normal((len(offsets), n)) / 9
    x = rng.standard_normal(n)
    for dtype in (torch.float32, torch.float64):
        _card_chain_check(offsets, torch.as_tensor(data, dtype=dtype).cuda(),
                          torch.as_tensor(x, dtype=dtype).cuda(), repeats=50)
