"""The port's matrix powers (ops/mpk.py), the fused A^p x (ops/mpk_fused.py,
kernel K4) and the SpMV / matrix-powers benchmark entry point
(bench/spmv_bench.py) against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions; the JAX side
runs the Pallas kernel in interpret mode on its overlap-tiled operator, as
the JAX package's own tests do.  Inputs are made with numpy from a seed, in
float64.  The kernel itself runs only on the card (`cuda` marker).
"""

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
from navierstokes_tpu_torch.ops import dia as tdia
from navierstokes_tpu_torch.ops import mpk as tmpk
from navierstokes_tpu_torch.ops import mpk_fused

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


def test_overlap_ratio_counts_the_rows_read():
    """overlap_ratio is the rows each sweep's frame reads, clipped to
    [0, n), summed over tiles: p for a tile as long as the matrix, about
    p + p(p-1)h/T for many tiles, as K4 reads them."""
    offsets = (-50, -1, 0, 1, 50)
    assert mpk_fused.overlap_ratio(1000, offsets, power=3, tile=1000) == 3.0
    n, tile = 100_000, 1000
    for p in (2, 3, 4):
        r = mpk_fused.overlap_ratio(n, offsets, power=p, tile=tile)
        assert abs(r - (p + p * (p - 1) * 50 / tile)) < 0.01
    # brute force on a ragged last tile
    n, tile, p = 2_345, 256, 3
    rows = 0
    for it in range(0, n, tile):
        for j in range(1, p + 1):
            frame = range(it - (p - j) * 50, it + tile + (p - j) * 50)
            rows += sum(1 for i in frame if 0 <= i < n)
    assert mpk_fused.overlap_ratio(n, offsets, power=p, tile=tile) \
        == rows / n


def test_choose_tile_fits_the_frames():
    """K4's row tile at the matrix-6 halo (h = 2,607): the two frames fit
    the 227 KB of shared memory, the tile never exceeds one per SM, and a
    halo that leaves no room for a 32-row tile raises."""
    offsets = (-2607, 0, 2607)
    n = 117_500
    for p in (2, 3, 4):
        for item in (4, 8):
            t = mpk_fused.choose_tile(n, offsets, power=p, itemsize=item)
            assert t % 32 == 0 and t >= 32
            assert mpk_fused.frame_values(t, 2607, p) * item \
                <= mpk_fused.SMEM_OPTIN
            assert t <= -(-n // mpk_fused.N_SM) + 31
    assert mpk_fused.choose_tile(n, offsets, power=4, itemsize=8) == 896
    assert mpk_fused.choose_tile(n, offsets, power=4, itemsize=8,
                                 n_sm=16) == 1472
    with pytest.raises(ValueError, match="shared memory"):
        mpk_fused.choose_tile(n, (-6000, 0, 6000), power=4, itemsize=8)


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
    bench's line format, every variant (K2, K1 on the plane layout, the
    fused K4 for spm2v/spm3v/spm4v) within rel 1e-12 of the chained plain
    reference, the unported JAX variants named with their slice."""
    mpk_fused.reset_counters()
    rows = spmv_bench.main(["--matrices", "1", "--kernel",
                            "spmv,spm2v,spm3v,spm4v", "--dtype", "float64",
                            "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Matrix loaded: 252 rows, ")
    timed = [ln for ln in out if _LINE.match(ln)]
    assert len(timed) == len(rows) == 3 + 3 * 4
    assert sum("not ported (ROADMAP slice" in ln for ln in out) == 3 * 4
    fused = [r for r in rows if "FUSED K4" in r["name"]]
    assert [r["kernel"] for r in fused] == ["spm2v", "spm3v", "spm4v"]
    assert mpk_fused.plain_calls > 0
    for r in rows:
        assert r["matrix"] == 1 and r["us"] > 0
        assert r["rel_err"] is None if r["name"].startswith("DIA plain") \
            else r["rel_err"] <= 1e-12


def test_bench_ortho_hook_on_the_cpu():
    """2SpMV with the CGS2 hook between the chained applies, on both
    layouts: the plane variant projects against the basis in its own
    layout and maps back to the reference at rel 1e-12."""
    rows = spmv_bench.main(["--matrices", "1", "--kernel", "2spmv",
                            "--ortho", "--dtype", "float64", "--device",
                            "cpu"])
    assert len(rows) == 3 and rows[0]["rel_err"] is None
    assert all(r["rel_err"] <= 1e-12 for r in rows[1:])


def test_bench_flags_outside_the_slice_and_rel_error():
    with pytest.raises(NotImplementedError, match="slice 8"):
        spmv_bench.main(["--matrices", "1", "--disc-cache", "c",
                         "--device", "cpu"])
    assert rel_error([3.0, 4.0], [3.0, 4.0]) == 0.0
    assert rel_error([3.0, 5.0], [3.0, 4.0]) == pytest.approx(0.2)
    assert np.isnan(rel_error(np.ones(3), np.zeros(3)))


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(system):
    """K4 against its plain version and p chained K2 launches on the card,
    f32 at rel 1e-5 and f64 at rel 1e-12, with nonzero data at the
    out-of-range entries and tiles from 32 rows to the chosen one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU or interpret mode")
    rng = np.random.default_rng(12)
    offsets = (-300, -41, -1, 0, 1, 41, 300)
    n = 20_011
    data = rng.standard_normal((len(offsets), n)) / 3
    x = rng.standard_normal(n)
    for dtype, bar in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        dt = torch.as_tensor(data, dtype=dtype).cuda()
        xt = torch.as_tensor(x, dtype=dtype).cuda()
        for p in (2, 3, 4):
            ref = mpk_fused.spmpv_dia_plain(offsets, dt, xt, power=p)
            chained = tmpk.matrix_power(offsets, dt, xt, p)
            for tile in (32, 160, None):
                z = mpk_fused.spmpv_dia(offsets, dt, xt, power=p, tile=tile)
                for want in (ref, chained):
                    err = float(torch.linalg.norm(z - want)
                                / torch.linalg.norm(want))
                    assert err <= bar, (dtype, p, tile, err)
