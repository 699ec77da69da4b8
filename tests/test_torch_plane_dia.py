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
from navierstokes_tpu_torch.mesh.box import (
    SCALING_SERIES_DIMS,
    box_mesh,
    scaling_series_mesh,
)
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


def _node_offsets(ny, nz):
    """The node offsets of a channel mesh of ny x nz cells across: the
    differences of node numbers within a tet.  They do not depend on the
    cells along the channel, so a slab one cell long has them all."""
    _, tets = box_mesh(1, ny, nz)
    return tuple(int(d) for d in np.unique(tets[:, :, None] - tets[:, None]))


def _sumset(offsets):
    """S_hat's band: the sums of two node offsets (solvers/schur.py)."""
    return tuple(sorted({a + b for a in offsets for b in offsets}))


# Matrices 6, 8 and 10 of the scaling series: cells across the channel
# (`scaling_series_mesh`), plane rows nbp of the 'sch' / 'tlp' prep, and the
# clusters of the 15 node offsets and of S_hat's 65 (first, last offset).
SERIES = {
    6: ((24, 24), 29_440,
        ((-651, -625), (-26, 26), (625, 651)),
        ((-1302, -1250), (-677, -599), (-52, 52), (599, 677),
         (1250, 1302))),
    8: ((40, 40), 127_872,
        ((-1723, -1681), (-42, 42), (1681, 1723)),
        ((-3446, -3362), (-1765, -1639), (-84, 84), (1639, 1765),
         (3362, 3446))),
    10: ((67, 67), 587_264,
         ((-4693, -4624), (-69, 69), (4624, 4693)),
         ((-9386, -9248), (-4762, -4555), (-138, 138), (4555, 4762),
          (9248, 9386))),
}
M10_15 = _node_offsets(67, 67)
M10_65 = _sumset(M10_15)


def _window_lo(node_offsets, itemsize):
    unit = band_ring.COPY_ALIGN // itemsize
    return min(node_offsets) // unit * unit


def _segments(node_offsets, plan):
    """{offset: (start, end)}: the window plane positions x_b[i0 + r + D]
    is read from, less r (start), and the end of its segment; each offset
    in the one cluster whose (lo, hi) holds it."""
    where, at = {}, 0
    for lo, hi in plan.clusters:
        w = plan.tn + hi - lo
        for d in node_offsets:
            if lo <= d <= hi:
                assert d not in where        # in exactly one segment
                where[d] = (at + d - lo, at + w)
        at += w
    assert set(where) == set(node_offsets) and at == plan.window
    return where


@pytest.mark.parametrize("matrix_id", [6, 8, 10])
def test_window_clusters_of_the_scaling_series(matrix_id):
    """The clustered x window at matrices 6, 8 and 10: the 15 node offsets
    fall in 3 clusters and S_hat's 65 in 5, at the plan's tile and at 256
    rows, and a window plane holds the tile's rows and each cluster's span
    (at matrix 10 and 256 rows: 1,056 and 2,264 values, against the whole
    band's 9,648 and 19,032)."""
    (ny, nz), nbp, want15, want65 = SERIES[matrix_id]
    assert SCALING_SERIES_DIMS[matrix_id][1:] == (ny, nz)
    offs = _node_offsets(ny, nz)
    if matrix_id == 6:      # the slab's offsets are the whole mesh's
        tets = scaling_series_mesh(6).tets
        assert offs == tuple(int(d) for d in np.unique(
            tets[:, :, None] - tets[:, None]))
    s_hat = _sumset(offs)
    assert len(offs) == 15 and len(s_hat) == 65
    for itemsize in (4, 8):
        unit = band_ring.COPY_ALIGN // itemsize
        for n_out, n_in, o, want in ((4, 4, offs, want15),
                                     (1, 1, s_hat, want65)):
            plan = tpd.tile_plan(o, n_out, n_in, nbp, itemsize)
            for tn in (plan.tn, 256):
                got = band_ring.window_clusters(o, tn, itemsize)
                assert got == tuple((lo // unit * unit, -(-hi // unit) * unit)
                                    for lo, hi in want)
                assert band_ring.window_values(tn, got) == sum(
                    tn + hi - lo for lo, hi in got)
            assert plan.clusters == band_ring.window_clusters(
                o, plan.tn, itemsize)
            assert plan.window == band_ring.window_values(plan.tn,
                                                          plan.clusters)
    if matrix_id == 10:
        for o, clustered, whole in ((offs, 1056, 9648),
                                    (s_hat, 2264, 19032)):
            clusters = band_ring.window_clusters(o, 256, 4)
            assert band_ring.window_values(256, clusters) == clustered
            # the band-wide window of one segment, as before clusters
            assert band_ring.window_values(
                256, ((_window_lo(o, 4), -_window_lo([-d for d in o], 4)),)
            ) == whole


_SERIES_CASES = [(nbp, WIDE_OFFS) for nbp in
                 (128, 2560, 7360, 29440, 58880, 235520)] + [
    (nbp, offs) for offs in (M10_15, M10_65) for nbp in (2560, 29440, 235520)]


@pytest.mark.parametrize("n_sm", [132, 5])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize(
    "nbp,offsets", _SERIES_CASES,
    ids=[str(nbp) if offs == WIDE_OFFS else
         f"{nbp}-m10_{len(offs)}" for nbp, offs in _SERIES_CASES])
def test_tile_plan_covers_every_row_once(nbp, offsets, itemsize, n_sm):
    """Tiles of `tn` rows, whole warps, cover [0, nbp) exactly once whether
    or not nbp is a multiple of tn; the blocks are at most one per SM and
    walk whole waves; the ring and the windows fit shared memory; every
    x index a term of a tile reads lies inside its cluster's segment of
    the x window.  Offset sets: a wide band, and matrix 10's 15 node
    offsets and S_hat's 65 (at small tiles more than MAX_CLUSTERS
    clusters, merged across the narrowest gaps)."""
    plan = tpd.tile_plan(offsets, 4, 4, nbp, itemsize, n_sm)
    assert plan is not None
    assert plan.tn % 32 == 0 and 32 <= plan.tn <= tpd.MAX_TILE
    assert (plan.n_tiles - 1) * plan.tn < nbp <= plan.n_tiles * plan.tn
    assert plan.grid == min(plan.n_tiles, n_sm)
    assert plan.windows == (2 if plan.n_tiles > plan.grid else 1)
    assert band_ring.MIN_STAGES <= plan.stages <= band_ring.MAX_STAGES
    assert 1 <= plan.group <= len(offsets)
    assert len(plan.clusters) <= band_ring.MAX_CLUSTERS
    assert plan.smem_bytes == band_ring.HEADER_BYTES + itemsize * (
        plan.stages * plan.group * 16 * plan.tn
        + plan.windows * 4 * plan.window)
    assert plan.smem_bytes <= band_ring.SMEM_LIMIT
    # whole waves: no tile larger than needed to fill n_sm blocks evenly
    waves = -(-plan.n_tiles // n_sm)
    assert plan.tn <= max(32, -(-nbp // (n_sm * waves)) + 31)
    covered = np.zeros(nbp, dtype=int)
    where = _segments(offsets, plan)
    for lo, hi in plan.clusters:
        assert (lo * itemsize) % band_ring.COPY_ALIGN == 0
        assert (hi * itemsize) % band_ring.COPY_ALIGN == 0
    for block in range(plan.grid):
        for tile in range(block, plan.n_tiles, plan.grid):
            i0 = tile * plan.tn
            rows = min(plan.tn, nbp - i0)
            covered[i0:i0 + rows] += 1
            assert (i0 * itemsize) % band_ring.COPY_ALIGN == 0
            for d in offsets:     # first and last row of the tile
                start, end = where[d]
                assert 0 <= start and start + rows - 1 < end
    assert np.all(covered == 1)


def test_matrix6_plan_is_one_tile_per_sm():
    """29,440 node rows on 132 SMs: 132 tiles of 224 rows, one wave, a
    4x4 stage one node offset; the clustered window leaves room for a
    seventh f64 stage (six with the band-wide window)."""
    plan = tpd.tile_plan(WIDE_OFFS, 4, 4, 29440, 4)
    assert (plan.tn, plan.n_tiles, plan.grid, plan.windows) == (224, 132,
                                                                132, 1)
    assert plan.stages == band_ring.MAX_STAGES and plan.group == 1
    assert tpd.tile_plan(WIDE_OFFS, 4, 4, 29440, 8).stages == 7


def test_plan_text_names_the_plan():
    """The one line the card's checks print for a plan: tile, tiles and
    blocks, G, clusters, stages, window and shared bytes."""
    plan = tpd.tile_plan(WIDE_OFFS, 4, 4, 29440, 4)
    assert tpd.plan_text(plan) == (
        f"tile 224, 132 tiles on 132 blocks, G 1, {len(plan.clusters)} "
        f"clusters, 8 stages, window {plan.window}, {plan.smem_bytes} B")


def _operator(rng, n_out, n_in, node_offs, nbp, dtype):
    data = torch.as_tensor(
        rng.standard_normal((n_out, n_in * len(node_offs), nbp)), dtype=dtype)
    x = torch.as_tensor(rng.standard_normal(n_in * nbp), dtype=dtype)
    return data, x


@pytest.mark.parametrize("case", ["aligned", "odd_nbp_f32", "odd_nbp_f64",
                                  "x_off_16", "band_too_wide",
                                  "band_wider_than_tile", "many_clusters",
                                  "m10_4x4", "m10_3x3", "m10_1x3",
                                  "m10_s_hat"])
def test_route_rule(case):
    """`plane_route` names 'tiled' exactly where its docstring says so:
    rows that start on 16 bytes and a window that fits shared memory (at
    most MAX_CLUSTERS segments: offsets spread wider are merged across the
    narrowest gaps); a forced 'tiled' raises where
    `tiled_plan` is None (here on the CPU the device check comes first, so
    the predicate is tested directly).  Matrix 10's forms (nbp 587,264)
    take 'tiled': their clustered windows fit."""
    rng = np.random.default_rng(3)
    offs, dtype, nbp, n_out, n_in = NODE_OFFS, torch.float32, 2560, 4, 4
    if case == "odd_nbp_f32":
        nbp = 2562                       # 2562 * 4 B is not a multiple of 16
    elif case == "odd_nbp_f64":
        dtype, nbp = torch.float64, 2561
    elif case == "band_too_wide":
        # one cluster (gaps of 500 <= the 512-row tile), window > 232,448 B
        offs, nbp = tuple(range(-30000, 30001, 500)), 65536
    elif case == "band_wider_than_tile":
        offs, n_out, n_in = (-900, 0, 900), 1, 1  # 3 segments, tile 32
        nbp = 128
    elif case == "many_clusters":
        offs = tuple(range(-4000, 4001, 1000))   # 9 gaps > the 32-row tile
    elif case.startswith("m10"):
        nbp = 587_264
        n_out, n_in = {"m10_4x4": (4, 4), "m10_3x3": (3, 3),
                       "m10_1x3": (1, 3), "m10_s_hat": (1, 1)}[case]
        offs = M10_65 if case == "m10_s_hat" else M10_15
    if case.startswith("m10"):       # the shape alone: no values needed
        data = torch.zeros(1, dtype=dtype).expand(
            n_out, n_in * len(offs), nbp)
        x = torch.zeros(n_in * nbp, dtype=dtype)
    else:
        data, x = _operator(rng, n_out, n_in, offs, nbp, dtype)
    if case == "x_off_16":
        x = torch.cat([x[:1], x])[1:]    # same values, 4 bytes off
        assert x.data_ptr() % 16 != 0
    plan = tpd.tiled_plan(offs, data, x, n_in)
    route = tpd.plane_route(offs, data, x, n_in)
    assert route in tpd.ROUTES
    assert (plan is not None) == (case in ("aligned", "band_wider_than_tile",
                                           "many_clusters")
                                  or case.startswith("m10"))
    if case == "many_clusters":      # the 7 widest gaps of 8 equal ones
        assert plan.clusters == ((-4000, -4000), (-3000, -3000),
                                 (-2000, -2000), (-1000, -1000), (0, 0),
                                 (1000, 1000), (2000, 2000), (3000, 4000))
    assert route == ("rows" if plan is None else "tiled")
    shape_plan = tpd.tile_plan(offs, n_out, n_in, nbp, data.element_size())
    if case == "x_off_16":               # the shape fits, the address not
        assert shape_plan is not None
    else:
        assert shape_plan == plan


def _tiled_emulation(node_offsets, data, x, n_in, nb, n_sm, halo=0):
    """K1's tiled route in plain torch: the kernel's tiles, its clustered x
    windows (a segment per cluster, exact zeros outside the source's valid
    range, [0, nbp) or [-halo, nbp + halo) with ghost rows) and its stage
    order (`group` node offsets a stage, b inner)."""
    n_out, _, nbp = data.shape
    size = data.element_size()
    plan = tpd.tile_plan(node_offsets, n_out, n_in, nbp, size, n_sm, halo)
    acc_dtype = torch.promote_types(data.dtype, torch.float32)
    where = _segments(node_offsets, plan)
    xs = x.reshape(n_in, nbp + 2 * halo)
    y = torch.full((n_out, nbp), float("nan"), dtype=x.dtype)
    for block in range(plan.grid):
        for tile in range(block, plan.n_tiles, plan.grid):
            i0 = tile * plan.tn
            rows = min(plan.tn, nbp - i0)
            win = torch.full((n_in, plan.window), float("nan"),
                             dtype=acc_dtype)
            at = 0
            for lo, hi in plan.clusters:
                w = plan.tn + hi - lo
                base = i0 + lo
                g0 = min(max(-halo, base), base + w)
                g1 = max(min(nbp + halo, base + w), g0)
                win[:, at:at + w] = 0
                win[:, at + g0 - base:at + g1 - base] = \
                    xs[:, halo + g0:halo + g1]
                at += w
            acc = torch.zeros((n_out, rows), dtype=acc_dtype)
            for d0 in range(0, len(node_offsets), plan.group):
                for i_d in range(d0, min(d0 + plan.group,
                                         len(node_offsets))):
                    start, end = where[node_offsets[i_d]]
                    assert start + rows <= end
                    for b in range(n_in):
                        seg = data[:, i_d * n_in + b,
                                   i0:i0 + rows].to(acc_dtype)
                        acc += seg * win[b, start:start + rows]
            acc[:, max(0, nb - i0):] = 0
            assert torch.isnan(y[:, i0:i0 + rows]).all()   # written once
            y[:, i0:i0 + rows] = acc.to(x.dtype)
    assert not torch.isnan(y).any()
    return y.reshape(-1), plan


S_HAT_LIKE = _sumset(_node_offsets(6, 6))    # 65 offsets, -114..114
SPREAD_OFFS = tuple(range(-651, 652, 93))     # 15 offsets, gaps of 93
_EMULATION_CASES = [
    (4, 4, 2500, 132, "node", False),  # 80 tiles of 32 rows, one per block
    (4, 4, 2500, 3, "node", False),    # 3 blocks walk 4 tiles, last partial
    (3, 3, 300, 132, "node", False),   # a band (+-7) crossing every tile
    (1, 3, 2000, 2, "node", False),    # two window buffers, 4 tiles of 512
    (1, 1, 90, 132, "node", False),    # fewer live rows than one tile
    (1, 1, 3000, 132, "s_hat", False),  # 65 offsets, 5 clusters, 94 tiles
    (1, 1, 3000, 5, "s_hat", False),   # one cluster, several stages a tile
    (1, 3, 1500, 2, "s_hat", False),   # 1x3 on 65 offsets
    (4, 4, 2500, 132, "node", True),   # ghost rows, as on a shard
    (1, 1, 3000, 132, "s_hat", True),
    (3, 3, 2500, 132, "spread", True),  # 14 gaps > the tile: 8 segments
]


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize(
    "n_out,n_in,nb,n_sm,offsets,ghosts", _EMULATION_CASES,
    ids=["-".join(map(str, c[:4])) + (f"-{c[4]}" if c[4] != "node" else "")
         + ("-ghost" if c[5] else "") for c in _EMULATION_CASES])
def test_tiled_emulation_matches_plain_and_pallas(dtype, bar, n_out, n_in, nb,
                                                  n_sm, offsets, ghosts):
    """The tiled route's tiles, clustered windows and stage grouping,
    emulated in plain torch, against the plain version (f32 rel 1e-6: sums
    may round in another order; f64 1e-13) and against spmv_planes_pallas
    in interpret mode on the same numpy inputs (f64, rel 1e-12); on the
    node offsets and on 65 S_hat-like ones, and in the ghost-row form (the
    plain version and the JAX kernel's x_prehalo=True).  The data is random
    and nonzero where i + D leaves the matrix and in the padding rows; the
    ghost rows are random too."""
    offs = {"node": NODE_OFFS, "s_hat": S_HAT_LIKE,
            "spread": SPREAD_OFFS}[offsets]
    rng = np.random.default_rng(100 * nb + 10 * n_out + n_in + len(offs))
    nt = n_in * len(offs)
    nbp = tpd.plane_nbp(nb)
    planes = rng.standard_normal((n_out, nt, nbp))
    data = torch.as_tensor(planes, dtype=dtype)
    h = max(abs(d) for d in offs)
    g = tpd.ghost_width(offs, data.element_size()) if ghosts else 0
    if ghosts:      # JAX's h ghost rows random, the extra g - h zero
        xh = rng.standard_normal((n_in, nbp + 2 * h))
        xg = np.zeros((n_in, nbp + 2 * g))
        xg[:, g - h:g + nbp + h] = xh
        x = torch.as_tensor(xg.reshape(-1), dtype=dtype)
    else:
        x_live = rng.standard_normal((n_in, nb))
        x = torch.zeros((n_in, nbp), dtype=dtype)
        x[:, :nb] = torch.as_tensor(x_live, dtype=dtype)
        x = x.reshape(-1)

    y, plan = _tiled_emulation(offs, data, x, n_in, nb, n_sm, halo=g)
    if n_sm < 132:
        assert plan.n_tiles > plan.grid and plan.windows == 2
    if offsets == "s_hat":
        assert len(offs) == 65
        assert plan.group > 1 or n_in > 1    # a 1x1 stage: several offsets
    if offsets == "spread":
        assert len(plan.clusters) == band_ring.MAX_CLUSTERS
    ref = tpd.spmv_planes_plain(offs, data, x, n_in=n_in, nb=nb, halo=g)
    err = float(torch.linalg.norm(y.double() - ref.double())
                / torch.linalg.norm(ref.double()))
    assert err <= bar, err
    assert torch.all(y.reshape(n_out, nbp)[:, nb:] == 0)

    if dtype == torch.float64:
        if ghosts:
            tiled = jpd.pretile_planes(jnp.asarray(planes), nbp, tile=nbp,
                                       nbp=nbp)
            y_jax = np.asarray(jpd.spmv_planes_pallas(
                offs, tiled, jnp.asarray(xh.reshape(-1)), n_in=n_in, nb=nb,
                interpret=True, x_prehalo=True)).reshape(n_out, nbp)[:, :nb]
        else:
            tile = 1024
            tiled = jpd.pretile_planes(jnp.asarray(planes[:, :, :nb]), nb,
                                       tile=tile)
            nbp_j = tiled.shape[0] * tile
            xp = np.zeros((n_in, nbp_j))
            xp[:, :nb] = x_live
            y_jax = np.asarray(jpd.spmv_planes_pallas(
                offs, tiled, jnp.asarray(xp.reshape(-1)), n_in=n_in, nb=nb,
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
    window segments, offsets, header and shared-memory bytes; the barriers
    fit the header; the largest window the plan accepts (one cluster, beside
    two stages of one offset) stays inside the 232,448-byte limit, and one
    16-byte unit more is refused."""
    ring = _constants(cuda_lib.CSRC / "band_ring.cuh")
    k1 = _constants(cuda_lib.CSRC / "plane_dia.cu")
    assert ring["kMaxStages"] == band_ring.MAX_STAGES
    assert ring["kMaxClusters"] == band_ring.MAX_CLUSTERS
    assert ring["kHeaderBytes"] == band_ring.HEADER_BYTES
    assert ring["kSmemLimit"] == band_ring.SMEM_LIMIT == 232_448
    assert ring["kProducerThreads"] == band_ring.WARP == 32
    assert k1["kMaxOffsets"] == tpd.MAX_OFFSETS
    assert k1["kMaxTile"] == tpd.MAX_TILE
    assert k1["kThreads"] == tpd.PAD
    # full[kMaxStages], empty[kMaxStages], two window pairs, 8 bytes each
    assert (2 * ring["kMaxStages"] + 4) * 8 <= ring["kHeaderBytes"]
    assert tpd.MAX_TILE + ring["kProducerThreads"] <= 1024
    # a window's copies: one producer lane per segment and input plane
    assert 4 * band_ring.MAX_CLUSTERS <= band_ring.WARP
    for itemsize in (4, 8):
        # 1x1, one tile of 512 rows on one SM, offsets 512 apart: one
        # cluster; two stages of one offset, the rest is window
        tn = tpd.MAX_TILE
        room = band_ring.SMEM_LIMIT - band_ring.HEADER_BYTES \
            - 2 * tn * itemsize
        span = room // itemsize - tn
        span -= span % (band_ring.COPY_ALIGN // itemsize)
        offsets = tuple(range(0, span, tn)) + (span,)
        assert len(offsets) <= tpd.MAX_OFFSETS
        widest = tpd.tile_plan(offsets, 1, 1, tn, itemsize, 1)
        assert widest is not None and widest.tn == tn
        assert (widest.stages, widest.group, len(widest.clusters)) == (2, 1, 1)
        assert band_ring.SMEM_LIMIT - band_ring.COPY_ALIGN \
            < widest.smem_bytes <= band_ring.SMEM_LIMIT
        assert tpd.tile_plan(offsets[:-1] + (span + 1,), 1, 1, tn, itemsize,
                             1) is None


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
