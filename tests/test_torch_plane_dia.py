"""The port's plane layout and kernel K1 (navierstokes_tpu_torch/ops/plane_dia.py)
against the JAX package's `ops/plane_dia.py`.

On the CPU the port's wrapper runs K1's plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as the JAX package's own tests do.
Inputs are made with numpy from a seed and handed to both.  The kernel
itself runs only on the card (`cuda` marker).
"""

import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.ops import plane_dia as jpd
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.ops import band_ring, cuda_lib
from navierstokes_tpu_torch.ops import plane_dia as tpd

torch.set_num_threads(1)

NODE_OFFS = (-7, -5, -1, 0, 1, 2, 6)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scalar_offsets(node_offs):
    return tuple(sorted({4 * d + e for d in node_offs for e in range(-3, 4)}))


@pytest.mark.parametrize("nb", [300, 2500])
@pytest.mark.parametrize("n_out,n_in", [(4, 4), (3, 3), (1, 3), (1, 1)])
def test_plain_matches_pallas(nb, n_out, n_in):
    """K1's plain version == spmv_planes_pallas (interpret) in f64, rel
    1e-12 (same terms in the same order; only rounding may differ).  The
    random planes are nonzero also where i + D leaves [0, nb): both sides
    must read x as zero there."""
    rng = np.random.default_rng(1000 * nb + 10 * n_out + n_in)
    nt = n_in * len(NODE_OFFS)
    planes = rng.standard_normal((n_out, nt, nb))
    x_live = rng.standard_normal((n_in, nb))

    tile = 1024
    tiled = jpd.pretile_planes(jnp.asarray(planes), nb, tile=tile)
    nbp = tiled.shape[0] * tile
    xp = np.zeros((n_in, nbp))
    xp[:, :nb] = x_live
    y_jax = np.asarray(jpd.spmv_planes_pallas(
        NODE_OFFS, tiled, jnp.asarray(xp.reshape(-1)), n_in=n_in, nb=nb,
        interpret=True))

    data = torch.as_tensor(convert.planes_from_tiled(tiled))
    assert data.shape == (n_out, nt, nbp)
    y = tpd.spmv_planes(NODE_OFFS, data, torch.as_tensor(xp.reshape(-1)),
                        n_in=n_in, nb=nb).numpy()
    err = np.linalg.norm(y - y_jax) / np.linalg.norm(y_jax)
    assert err <= 1e-12, err

    # the port's own (smaller) padding gives the same live rows
    nbp_t = tpd.plane_nbp(nb)
    data_t = torch.zeros((n_out, nt, nbp_t), dtype=torch.float64)
    data_t[:, :, :nb] = torch.as_tensor(planes)
    x_t = torch.zeros((n_in, nbp_t), dtype=torch.float64)
    x_t[:, :nb] = torch.as_tensor(x_live)
    y_t = tpd.spmv_planes(NODE_OFFS, data_t, x_t.reshape(-1), n_in=n_in,
                          nb=nb).reshape(n_out, nbp_t)
    live = y_jax.reshape(n_out, nbp)[:, :nb]
    err = np.linalg.norm(y_t[:, :nb].numpy() - live) / np.linalg.norm(live)
    assert err <= 1e-12, err
    assert torch.all(y_t[:, nb:] == 0)


def test_plain_float32_accumulates_in_float32():
    rng = np.random.default_rng(5)
    nb, nbp = 200, 256
    data = torch.as_tensor(rng.standard_normal((4, 4 * len(NODE_OFFS), nbp)),
                           dtype=torch.float32)
    x = torch.as_tensor(rng.standard_normal(4 * nbp), dtype=torch.float32)
    y = tpd.spmv_planes(NODE_OFFS, data, x, n_in=4, nb=nb)
    y64 = tpd.spmv_planes(NODE_OFFS, data.double(), x.double(), n_in=4, nb=nb)
    assert y.dtype == torch.float32
    err = float(torch.linalg.norm(y.double() - y64) / torch.linalg.norm(y64))
    assert err < 1e-6, err


def test_node_offsets_and_terms_match_jax():
    offsets = _scalar_offsets(NODE_OFFS)
    assert tpd.node_offsets_from_scalar(offsets) == \
        jpd.node_offsets_from_scalar(offsets) == NODE_OFFS
    for n_in in (1, 3, 4):
        assert tpd.plane_terms(NODE_OFFS, n_in) == \
            jpd.plane_terms(NODE_OFFS, n_in)
    with pytest.raises(ValueError):
        tpd.node_offsets_from_scalar((0, 9))


def test_extract_planes_matches_jax():
    """Pure copies: exact equality, including the zero-padded form."""
    rng = np.random.default_rng(11)
    nb = 50
    offsets = _scalar_offsets((-2, 0, 1))
    data = rng.standard_normal((len(offsets), 4 * nb))
    p_jax = np.asarray(jpd.extract_planes(offsets, jnp.asarray(data), nb))
    p = tpd.extract_planes(offsets, torch.as_tensor(data), nb).numpy()
    np.testing.assert_array_equal(p, p_jax)
    p_pad = tpd.extract_planes(offsets, torch.as_tensor(data), nb,
                               nbp=128).numpy()
    np.testing.assert_array_equal(p_pad[:, :, :nb], p_jax)
    assert np.all(p_pad[:, :, nb:] == 0)


def test_to_from_planes_match_jax():
    rng = np.random.default_rng(3)
    nb, nbp = 37, 64
    x = rng.standard_normal(4 * nb)
    xp = tpd.to_planes(torch.as_tensor(x), nb, nbp)
    np.testing.assert_array_equal(
        xp.numpy(), np.asarray(jpd.to_planes(jnp.asarray(x), nb, nbp)))
    np.testing.assert_array_equal(tpd.from_planes(xp, nb, nbp).numpy(), x)
    np.testing.assert_array_equal(
        tpd.from_planes(xp, nb, nbp).numpy(),
        np.asarray(jpd.from_planes(jnp.asarray(xp.numpy()), nb, nbp)))


def test_convert_tile_major_to_plane_major():
    rng = np.random.default_rng(4)
    nb, tile = 300, 128
    planes = rng.standard_normal((3, 12, nb))
    tiled = jpd.pretile_planes(jnp.asarray(planes), nb, tile=tile)
    assert tiled.shape == (3, 3, 12, tile)          # (grid, n_out, NT, tile)
    flat = convert.planes_from_tiled(tiled)
    assert flat.shape == (3, 12, 3 * tile)
    np.testing.assert_array_equal(flat[:, :, :nb], planes)
    assert np.all(flat[:, :, nb:] == 0)


def test_cpu_dispatch_counts_plain_only():
    rng = np.random.default_rng(8)
    nbp = 128
    data = torch.as_tensor(rng.standard_normal((1, len(NODE_OFFS), nbp)))
    x = torch.as_tensor(rng.standard_normal(nbp))
    tpd.reset_counters()
    tpd.spmv_planes(NODE_OFFS, data, x, n_in=1, nb=100)
    tpd.spmv_plane(NODE_OFFS, torch.zeros(4, 4 * len(NODE_OFFS), nbp,
                                          dtype=torch.float64),
                   torch.zeros(4 * nbp, dtype=torch.float64), nb=100)
    assert tpd.kernel_launches == 0
    assert tpd.plain_calls == 2
    tpd.reset_counters()
    assert tpd.plain_calls == 0


def test_kernel_wrapper_rejects_what_it_cannot_take():
    nt = 4 * len(NODE_OFFS)
    data = torch.zeros(4, nt, 128, dtype=torch.float64)
    x = torch.zeros(4 * 128, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tpd.spmv_planes_cuda(NODE_OFFS, data, x, n_in=4, nb=100)
    with pytest.raises(ValueError, match="1..4"):
        tpd.spmv_planes(NODE_OFFS, torch.zeros(5, nt, 128), x, n_in=4, nb=1)
    with pytest.raises(ValueError, match="1..128"):
        offs = tuple(range(129))
        tpd.spmv_planes(offs, torch.zeros(1, 129, 128), torch.zeros(128),
                        n_in=1, nb=1)
    with pytest.raises(ValueError, match="shape"):
        tpd.spmv_planes(NODE_OFFS, data, x[:-1], n_in=4, nb=100)
    with pytest.raises(TypeError, match="dtype"):
        tpd.spmv_planes(NODE_OFFS, data, x.float(), n_in=4, nb=100)
    with pytest.raises(ValueError, match="nb="):
        tpd.spmv_planes(NODE_OFFS, data, x, n_in=4, nb=129)


def test_import_needs_neither_nvcc_nor_triton(tmp_path):
    """With no nvcc on PATH the package imports, runs the plain version on
    the CPU, builds nothing and never imports triton."""
    code = (
        "import sys, torch\n"
        "from navierstokes_tpu_torch.ops import plane_dia as p, cuda_lib\n"
        "y = p.spmv_planes((0,), torch.ones(1, 1, 128), torch.ones(128),"
        " n_in=1, nb=128)\n"
        "assert float(y.sum()) == 128.0\n"
        "assert 'triton' not in sys.modules\n"
        "assert not cuda_lib._loaded\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """K1, both routes, against its plain version on the card: 4x4 and
    sub-block forms, f32 at rel 1e-5 and f64 at rel 1e-12, padding rows
    exactly zero, the data nonzero where i + D leaves the matrix."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU or interpret mode")
    rng = np.random.default_rng(21)
    nb, nbp = 2500, tpd.plane_nbp(2500)
    for dtype, bar in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for n_out, n_in in ((4, 4), (3, 3), (1, 3), (3, 1), (1, 1)):
            data = torch.zeros(n_out, n_in * len(NODE_OFFS), nbp, dtype=dtype)
            data[:, :, :nb] = torch.as_tensor(
                rng.standard_normal((n_out, n_in * len(NODE_OFFS), nb)))
            x = torch.as_tensor(rng.standard_normal(n_in * nbp), dtype=dtype)
            data, x = data.cuda(), x.cuda()
            ref = tpd.spmv_planes_plain(NODE_OFFS, data, x, n_in=n_in, nb=nb)
            for route in (None,) + tpd.ROUTES:
                y = tpd.spmv_planes_cuda(NODE_OFFS, data, x, n_in=n_in, nb=nb,
                                         route=route)
                torch.cuda.synchronize()
                err = float(torch.linalg.norm(y - ref)
                            / torch.linalg.norm(ref))
                assert err <= bar, (dtype, n_out, n_in, route, err)
                assert torch.all(y.reshape(n_out, nbp)[:, nb:] == 0)


# ---- what Python decides for the tiled route -------------------------------

WIDE_OFFS = (-651, -620, -31, -1, 0, 1, 31, 620, 651)


def _window_lo(node_offsets, itemsize):
    unit = band_ring.COPY_ALIGN // itemsize
    return min(node_offsets) // unit * unit


@pytest.mark.parametrize("n_sm", [132, 5])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("nbp", [128, 2560, 7360, 29440, 58880, 235520])
def test_tile_plan_covers_every_row_once(nbp, itemsize, n_sm):
    """Tiles of `tn` rows, whole warps, cover [0, nbp) exactly once whether
    or not nbp is a multiple of tn; the blocks are at most one per SM and
    walk whole waves; the ring and the windows fit shared memory; every
    i + D a tile needs lies inside its x window."""
    plan = tpd.tile_plan(WIDE_OFFS, 4, 4, nbp, itemsize, n_sm)
    assert plan.tn % 32 == 0 and 32 <= plan.tn <= tpd.MAX_TILE
    assert (plan.n_tiles - 1) * plan.tn < nbp <= plan.n_tiles * plan.tn
    assert plan.grid == min(plan.n_tiles, n_sm)
    assert plan.windows == (2 if plan.n_tiles > plan.grid else 1)
    assert band_ring.MIN_STAGES <= plan.stages <= band_ring.MAX_STAGES
    assert plan.smem_bytes == band_ring.HEADER_BYTES + itemsize * (
        plan.stages * 16 * plan.tn + plan.windows * 4 * plan.window)
    assert plan.smem_bytes <= band_ring.SMEM_LIMIT
    # whole waves: no tile larger than needed to fill n_sm blocks evenly
    waves = -(-plan.n_tiles // n_sm)
    assert plan.tn <= max(32, -(-nbp // (n_sm * waves)) + 31)
    covered = np.zeros(nbp, dtype=int)
    lo = _window_lo(WIDE_OFFS, itemsize)
    assert (plan.window * itemsize) % band_ring.COPY_ALIGN == 0
    for block in range(plan.grid):
        for tile in range(block, plan.n_tiles, plan.grid):
            i0 = tile * plan.tn
            rows = min(plan.tn, nbp - i0)
            covered[i0:i0 + rows] += 1
            assert (i0 * itemsize) % band_ring.COPY_ALIGN == 0
            for d in WIDE_OFFS:     # first and last row of the tile
                assert 0 <= d - lo and rows - 1 + d - lo < plan.window
    assert np.all(covered == 1)


def test_matrix6_plan_is_one_tile_per_sm():
    """29,440 node rows on 132 SMs: 132 tiles of 224 rows, one wave."""
    plan = tpd.tile_plan(WIDE_OFFS, 4, 4, 29440, 4)
    assert (plan.tn, plan.n_tiles, plan.grid, plan.windows) == (224, 132,
                                                                132, 1)
    assert plan.stages == band_ring.MAX_STAGES
    assert tpd.tile_plan(WIDE_OFFS, 4, 4, 29440, 8).stages == 6


def _operator(rng, n_out, n_in, node_offs, nbp, dtype):
    data = torch.as_tensor(
        rng.standard_normal((n_out, n_in * len(node_offs), nbp)), dtype=dtype)
    x = torch.as_tensor(rng.standard_normal(n_in * nbp), dtype=dtype)
    return data, x


@pytest.mark.parametrize("case", ["aligned", "odd_nbp_f32", "odd_nbp_f64",
                                  "x_off_16", "band_too_wide",
                                  "band_wider_than_tile"])
def test_route_rule(case):
    """`plane_route` names 'tiled' exactly where its docstring says so:
    rows that start on 16 bytes and a window that fits shared memory; a
    forced 'tiled' raises where `tiled_plan` is None (here on the CPU the
    device check comes first, so the predicate is tested directly)."""
    rng = np.random.default_rng(3)
    offs, dtype, nbp, n = NODE_OFFS, torch.float32, 2560, 4
    if case == "odd_nbp_f32":
        nbp = 2562                       # 2562 * 4 B is not a multiple of 16
    elif case == "odd_nbp_f64":
        dtype, nbp = torch.float64, 2561
    elif case == "band_too_wide":
        offs = (-30000, 0, 30000)        # window alone > 232,448 B
        nbp = 65536
    elif case == "band_wider_than_tile":
        offs, n = (-900, 0, 900), 1      # 1x1: window 1,832 values, tile 32
        nbp = 128
    data, x = _operator(rng, n, n, offs, nbp, dtype)
    if case == "x_off_16":
        x = torch.cat([x[:1], x])[1:]    # same values, 4 bytes off
        assert x.data_ptr() % 16 != 0
    plan = tpd.tiled_plan(offs, data, x, n)
    route = tpd.plane_route(offs, data, x, n)
    assert route in tpd.ROUTES
    assert (plan is not None) == (case in ("aligned", "band_wider_than_tile"))
    assert route == ("rows" if plan is None else "tiled")
    shape_plan = tpd.tile_plan(offs, n, n, nbp, data.element_size())
    if case == "x_off_16":               # the shape fits, the address not
        assert shape_plan is not None
    else:
        assert shape_plan == plan


def _tiled_emulation(node_offsets, data, x, n_in, nb, n_sm):
    """K1's tiled route in plain torch: the kernel's tiles, zero-filled x
    windows and stage order (one node offset a stage, b inner)."""
    n_out, _, nbp = data.shape
    size = data.element_size()
    plan = tpd.tile_plan(node_offsets, n_out, n_in, nbp, size, n_sm)
    acc_dtype = torch.promote_types(data.dtype, torch.float32)
    lo = _window_lo(node_offsets, size)
    xs = x.reshape(n_in, nbp)
    y = torch.full((n_out, nbp), float("nan"), dtype=x.dtype)
    for block in range(plan.grid):
        for tile in range(block, plan.n_tiles, plan.grid):
            i0 = tile * plan.tn
            rows = min(plan.tn, nbp - i0)
            base = i0 + lo
            g0, g1 = max(0, base), min(nbp, base + plan.window)
            win = torch.zeros((n_in, plan.window), dtype=acc_dtype)
            win[:, g0 - base:g1 - base] = xs[:, g0:g1]
            acc = torch.zeros((n_out, rows), dtype=acc_dtype)
            for i_d, d in enumerate(node_offsets):
                for b in range(n_in):
                    seg = data[:, i_d * n_in + b, i0:i0 + rows].to(acc_dtype)
                    acc += seg * win[b, d - lo:d - lo + rows]
            acc[:, max(0, nb - i0):] = 0
            assert torch.isnan(y[:, i0:i0 + rows]).all()   # written once
            y[:, i0:i0 + rows] = acc.to(x.dtype)
    assert not torch.isnan(y).any()
    return y.reshape(-1), plan


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("n_out,n_in,nb,n_sm", [
    (4, 4, 2500, 132),     # 80 tiles of 32 rows, one per block
    (4, 4, 2500, 3),       # 3 blocks walk 4 tiles each, the last one partial
    (3, 3, 300, 132),      # a band (+-7) that crosses every tile edge
    (1, 3, 1000, 2),       # two window buffers, odd tile count
    (1, 1, 90, 132),       # fewer live rows than one tile
])
def test_tiled_emulation_matches_plain_and_pallas(dtype, bar, n_out, n_in, nb,
                                                  n_sm):
    """The tiled route's tile, window and stage order, emulated in plain
    torch, against the plain version (f32 rel 1e-6: sums may round in
    another order; f64 1e-13) and against spmv_planes_pallas in interpret
    mode on the same numpy inputs.  The data is random and nonzero where
    i + D leaves the matrix and in the padding rows."""
    rng = np.random.default_rng(100 * nb + 10 * n_out + n_in)
    nt = n_in * len(NODE_OFFS)
    nbp = tpd.plane_nbp(nb)
    planes = rng.standard_normal((n_out, nt, nbp))
    x_live = rng.standard_normal((n_in, nb))
    data = torch.as_tensor(planes, dtype=dtype)
    x = torch.zeros((n_in, nbp), dtype=dtype)
    x[:, :nb] = torch.as_tensor(x_live, dtype=dtype)
    x = x.reshape(-1)

    y, plan = _tiled_emulation(NODE_OFFS, data, x, n_in, nb, n_sm)
    if n_sm < 132:
        assert plan.n_tiles > plan.grid and plan.windows == 2
    ref = tpd.spmv_planes_plain(NODE_OFFS, data, x, n_in=n_in, nb=nb)
    err = float(torch.linalg.norm(y.double() - ref.double())
                / torch.linalg.norm(ref.double()))
    assert err <= bar, err
    assert torch.all(y.reshape(n_out, nbp)[:, nb:] == 0)

    if dtype == torch.float64:
        tile = 1024
        tiled = jpd.pretile_planes(jnp.asarray(planes[:, :, :nb]), nb,
                                   tile=tile)
        nbp_j = tiled.shape[0] * tile
        xp = np.zeros((n_in, nbp_j))
        xp[:, :nb] = x_live
        y_jax = np.asarray(jpd.spmv_planes_pallas(
            NODE_OFFS, tiled, jnp.asarray(xp.reshape(-1)), n_in=n_in, nb=nb,
            interpret=True)).reshape(n_out, nbp_j)[:, :nb]
        got = y.reshape(n_out, nbp)[:, :nb].numpy()
        assert np.linalg.norm(got - y_jax) / np.linalg.norm(y_jax) <= 1e-12


def test_route_counters_and_cpu_tensors():
    """Launches are counted per route; a CPU tensor never reaches a CUDA
    route, whichever is asked for."""
    assert set(tpd.route_launches) == set(tpd.ROUTES) == {"tiled", "rows"}
    rng = np.random.default_rng(8)
    data, x = _operator(rng, 4, 4, NODE_OFFS, 128, torch.float64)
    tpd.reset_counters()
    tpd.spmv_planes(NODE_OFFS, data, x, n_in=4, nb=100)
    for route in tpd.ROUTES + (None,):
        with pytest.raises(ValueError, match="CUDA"):
            tpd.spmv_planes_cuda(NODE_OFFS, data, x, n_in=4, nb=100,
                                 route=route)
    assert tpd.plain_calls == 1 and tpd.kernel_launches == 0
    assert tpd.route_launches == {"tiled": 0, "rows": 0}
    assert tpd.form_launches == {}


def _constants(path):
    """{name: value} of the `constexpr int kName = <integer>;` lines."""
    text = path.read_text()
    return {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}


def test_constants_match_the_sources():
    """The wrappers mirror the kernels' limits: tile size, stage count,
    offsets, header and shared-memory bytes; the barriers fit the header;
    the largest window the plan accepts stays inside the 232,448-byte
    limit, and one 16-byte unit more is refused."""
    ring = _constants(cuda_lib.CSRC / "band_ring.cuh")
    k1 = _constants(cuda_lib.CSRC / "plane_dia.cu")
    assert ring["kMaxStages"] == band_ring.MAX_STAGES
    assert ring["kHeaderBytes"] == band_ring.HEADER_BYTES
    assert ring["kSmemLimit"] == band_ring.SMEM_LIMIT == 232_448
    assert ring["kProducerThreads"] == 32
    assert k1["kMaxOffsets"] == tpd.MAX_OFFSETS
    assert k1["kMaxTile"] == tpd.MAX_TILE
    assert k1["kThreads"] == tpd.PAD
    # full[kMaxStages], empty[kMaxStages], two window pairs, 8 bytes each
    assert (2 * ring["kMaxStages"] + 4) * 8 <= ring["kHeaderBytes"]
    assert tpd.MAX_TILE + ring["kProducerThreads"] <= 1024
    for itemsize in (4, 8):
        # 1x1 on one tile of 32 rows: two stages, the rest is window
        room = band_ring.SMEM_LIMIT - band_ring.HEADER_BYTES \
            - 2 * 32 * itemsize
        span = room // itemsize - 32
        span -= span % (band_ring.COPY_ALIGN // itemsize)
        widest = tpd.tile_plan((0, span), 1, 1, 128, itemsize)
        assert widest is not None and widest.stages == 2
        assert band_ring.SMEM_LIMIT - band_ring.COPY_ALIGN \
            < widest.smem_bytes <= band_ring.SMEM_LIMIT
        assert tpd.tile_plan((0, span + 1), 1, 1, 128, itemsize) is None


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited header must rebuild the libraries that include it."""
    names = {n: [p.name for p in cuda_lib.source_files(n)]
             for n in cuda_lib.SOURCES}
    assert names["plane_dia"] == ["plane_dia.cu", "band_ring.cuh"]
    assert names["dia"] == ["dia.cu"]
    assert names["cgs2"] == ["cgs2.cu", "grid_sync.cuh", "band_ring.cuh"]
    assert names["mpk"] == ["mpk.cu", "grid_sync.cuh", "band_ring.cuh"]
    before = {n: cuda_lib.source_digest(n) for n in cuda_lib.SOURCES}
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, copy)
    monkeypatch.setattr(cuda_lib, "CSRC", copy)
    assert {n: cuda_lib.source_digest(n) for n in cuda_lib.SOURCES} == before
    with open(copy / "grid_sync.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: cuda_lib.source_digest(n) for n in cuda_lib.SOURCES}
    for name in ("cgs2", "mpk"):
        assert after[name] != before[name]
    for name in ("plane_dia", "dia"):
        assert after[name] == before[name]
    with open(copy / "band_ring.cuh", "a") as f:
        f.write("// edited\n")
    again = {n: cuda_lib.source_digest(n) for n in cuda_lib.SOURCES}
    assert again["plane_dia"] != before["plane_dia"]
    for name in ("cgs2", "mpk"):
        assert again[name] != after[name]
    assert again["dia"] == before["dia"]
