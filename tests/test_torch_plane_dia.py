"""The port's plane layout and kernel K1 (navierstokes_tpu_torch/ops/plane_dia.py)
against the JAX package's `ops/plane_dia.py`.

On the CPU the port's wrapper runs K1's plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as the JAX package's own tests do.
Inputs are made with numpy from a seed and handed to both.  The kernel
itself runs only on the card (`cuda` marker).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.ops import plane_dia as jpd
from navierstokes_tpu_torch import convert
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
    with pytest.raises(ValueError, match="1..32"):
        offs = tuple(range(33))
        tpd.spmv_planes(offs, torch.zeros(1, 33, 128), torch.zeros(128),
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
    """K1 against its plain version on the card: 4x4 and sub-block forms,
    f32 at rel 1e-5 and f64 at rel 1e-12, padding rows exactly zero."""
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
            y = tpd.spmv_planes(NODE_OFFS, data, x, n_in=n_in, nb=nb)
            torch.cuda.synchronize()
            ref = tpd.spmv_planes_plain(NODE_OFFS, data, x, n_in=n_in, nb=nb)
            err = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
            assert err <= bar, (dtype, n_out, n_in, err)
            assert torch.all(y.reshape(n_out, nbp)[:, nb:] == 0)
