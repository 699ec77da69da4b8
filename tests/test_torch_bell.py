"""The port's block-ELL layer against the JAX package's: the pattern
(`sparse/bell.py`), the products (`ops/spmv.py`), the lazy fields and
cache of the discretization (`fem/assembly.py`) and the block-ELL half of
the partition layer (`parallel/partitioned.py`).

Patterns and maps must be equal exactly; products are compared in float64
at rel 1e-12 (sums in another order: round-off only).  Inputs are made
with numpy from a seed and handed to both packages.  The JAX partitioned
products run on the virtual CPU devices of `tests/conftest.py`, the
port's over `[cpu] * P`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as DeviceMesh

from navierstokes_tpu.fem import assembly as jas
from navierstokes_tpu.mesh import box as jbox
from navierstokes_tpu.ops import spmv as jspmv
from navierstokes_tpu.parallel import partitioned as jpart
from navierstokes_tpu.sparse import bcsr as jbcsr
from navierstokes_tpu.sparse import bell as jbell
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.fem import assembly as tas
from navierstokes_tpu_torch.ops import spmv as tspmv
from navierstokes_tpu_torch.parallel import partitioned as tpart
from navierstokes_tpu_torch.sparse import bell as tbell
from navierstokes_tpu_torch.sparse.bcsr import BCSR4

torch.set_num_threads(1)
CPU = torch.device("cpu")
REL = 1e-12          # float64 products, summed in another order


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh) of a small channel with an obstacle."""
    jm = jbox.channel_mesh(6, 3, 3, obstacle=True)
    return jm, convert.mesh_from_jax(jm)


@pytest.fixture(scope="module")
def jdisc(meshes):
    return jas.build_discretization(meshes[0], dtype=jnp.float64)


def _operators(indptr, indices, seed=0):
    """(JAX BCSR4, port BCSR4) with the same random blocks."""
    blocks = np.random.default_rng(seed).standard_normal((len(indices), 4, 4))
    return (jbcsr.BCSR4(indptr, indices, jnp.asarray(blocks)),
            BCSR4(indptr, indices, torch.as_tensor(blocks)))


@pytest.mark.parametrize("slots", [None, 40])
def test_pattern_equals_jax_exactly(meshes, slots):
    """The discretization's lazy block-ELL fields equal the JAX package's
    eager ones exactly, for the row degree and for slots above it; the
    pattern is not built until read."""
    jd = jas.build_discretization(meshes[0], dtype=jnp.float64,
                                  ell_slots=slots)
    td = tas.build_discretization(meshes[1], torch.float64, CPU,
                                  ell_slots=slots)
    assert td.ell_pattern is None
    assert td.ell_slots == jd.ell_slots
    assert td.ell_pattern is None
    np.testing.assert_array_equal(td.ell_indices, jd.ell_indices)
    np.testing.assert_array_equal(td.slot_of_bcsr, jd.slot_of_bcsr)
    assert td.ell_indices.dtype == jd.ell_indices.dtype
    assert td.slot_of_bcsr.dtype == jd.slot_of_bcsr.dtype
    ei, sb = tbell.bell_pattern_from_bcsr(jd.indptr, jd.indices, slots)
    np.testing.assert_array_equal(ei, jd.ell_indices)
    np.testing.assert_array_equal(sb, jd.slot_of_bcsr)


def test_too_few_slots_raise_as_in_jax(meshes, jdisc):
    degree = int(np.diff(jdisc.indptr).max())
    with pytest.raises(ValueError, match="max row degree") as je:
        jas.build_discretization(meshes[0], dtype=jnp.float64,
                                 ell_slots=degree - 1)
    with pytest.raises(ValueError, match="max row degree") as te:
        tas.build_discretization(meshes[1], torch.float64, CPU,
                                 ell_slots=degree - 1)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="max row degree"):
        tbell.bell_pattern_from_bcsr(jdisc.indptr, jdisc.indices, degree - 1)


@pytest.mark.parametrize("slots", [None, 40])
def test_values_and_products_match_jax(jdisc, slots):
    """bell_from_bcsr gives the JAX package's values bit for bit (each
    slot written once); spmv_bell, spmv_bell_multi, make_spmv('ell') and
    the dense matrix agree with the JAX package's at rel 1e-12."""
    jop, top = _operators(jdisc.indptr, jdisc.indices)
    jell = jbell.bell_from_bcsr(jop, slots)
    tell = tbell.bell_from_bcsr(top, slots)
    np.testing.assert_array_equal(tell.indices, jell.indices)
    assert torch.equal(tell.values, torch.as_tensor(np.array(jell.values)))
    assert (tell.nb, tell.slots, tell.nnzb, tell.shape) == (
        jell.nb, jell.slots, jell.nnzb, jell.shape)
    np.testing.assert_array_equal(tell.to_dense(), jell.to_dense())

    rng = np.random.default_rng(1)
    n = 4 * jdisc.nv
    x, X = rng.standard_normal(n), rng.standard_normal((n, 5))
    jidx = jnp.asarray(jell.indices)
    tidx = torch.as_tensor(tell.indices, dtype=torch.int64)
    y_j = np.asarray(jspmv.spmv_bell(jidx, jell.values, jnp.asarray(x)))
    y_t = tspmv.spmv_bell(tidx, tell.values, torch.as_tensor(x)).numpy()
    assert _rel(y_t, y_j) <= REL
    assert _rel(y_t, tell.to_dense() @ x) <= REL
    Y_j = np.asarray(jspmv.spmv_bell_multi(jidx, jell.values,
                                           jnp.asarray(X)))
    Y_t = tspmv.spmv_bell_multi(tidx, tell.values, torch.as_tensor(X))
    assert Y_t.shape == (n, 5) and _rel(Y_t.numpy(), Y_j) <= REL
    y_m = tspmv.make_spmv("ell", ell=tell)(torch.as_tensor(x))
    y_mj = np.asarray(jspmv.make_spmv("ell", ell=jell)(jnp.asarray(x)))
    assert _rel(y_m.numpy(), y_mj) <= REL
    # the oracle on the same BCSR blocks
    row_ids = torch.as_tensor(top.row_ids(), dtype=torch.int64)
    cols = torch.as_tensor(top.indices, dtype=torch.int64)
    y_o = tspmv.spmv_bcsr_ref(row_ids, cols, top.values, torch.as_tensor(x))
    assert _rel(y_t, y_o.numpy()) <= REL


@pytest.mark.parametrize("tile", [4, 8])
def test_windowed_product_matches_jax(jdisc, tile):
    """compute_window_starts equals the JAX package's; spmv_bell_windowed
    equals its JAX counterpart and the plain gather at rel 1e-12; a window
    narrower than a tile's span raises in both."""
    jop, top = _operators(jdisc.indptr, jdisc.indices, seed=2)
    jell, tell = jbell.bell_from_bcsr(jop), tbell.bell_from_bcsr(top)
    nb = jell.nb
    assert nb % tile == 0
    spans = [np.ptp(jell.indices[t:t + tile]) + 1
             for t in range(0, nb, tile)]
    window = int(max(spans))
    starts_j = jspmv.compute_window_starts(jell.indices, tile, window)
    starts_t = tspmv.compute_window_starts(tell.indices, tile, window)
    np.testing.assert_array_equal(starts_t, starts_j)
    assert starts_t.dtype == starts_j.dtype
    with pytest.raises(ValueError, match="exceeds window") as je:
        jspmv.compute_window_starts(jell.indices, tile, window - 1)
    with pytest.raises(ValueError, match="exceeds window") as te:
        tspmv.compute_window_starts(tell.indices, tile, window - 1)
    assert str(te.value) == str(je.value)

    x = np.random.default_rng(3).standard_normal(4 * nb)
    y_j = np.asarray(jspmv.spmv_bell_windowed(
        jnp.asarray(jell.indices), jell.values, jnp.asarray(x), tile=tile,
        window_starts=jnp.asarray(starts_j), window=window))
    tidx = torch.as_tensor(tell.indices, dtype=torch.int64)
    y_t = tspmv.spmv_bell_windowed(tidx, tell.values, torch.as_tensor(x),
                                   tile=tile, window_starts=starts_t,
                                   window=window)
    assert _rel(y_t.numpy(), y_j) <= REL
    y_plain = tspmv.spmv_bell(tidx, tell.values, torch.as_tensor(x))
    assert _rel(y_t.numpy(), y_plain.numpy()) <= REL


def test_cache_round_trips_the_block_ell_fields(meshes, jdisc, tmp_path):
    """A discretization with block-ELL slots asked for (or its pattern
    read) saves the pattern, and a load gives it back equal; one without
    saves no ELL files (a cache of before this layer), and its load builds
    the pattern at first use, equal to the JAX package's."""
    plain = tas.build_discretization(meshes[1], torch.float64, CPU)
    tas.save_discretization(plain, str(tmp_path / "plain"))
    assert plain.ell_pattern is None
    assert not (tmp_path / "plain" / "ell_indices.npy").exists()
    back = tas.load_discretization(str(tmp_path / "plain"), torch.float64,
                                   CPU)
    assert back.ell_pattern is None
    np.testing.assert_array_equal(back.ell_indices, jdisc.ell_indices)
    np.testing.assert_array_equal(back.slot_of_bcsr, jdisc.slot_of_bcsr)

    wide = tas.build_discretization(meshes[1], torch.float64, CPU,
                                    ell_slots=40)
    tas.save_discretization(wide, str(tmp_path / "wide"))
    back = tas.load_discretization(str(tmp_path / "wide"), torch.float64,
                                   CPU)
    assert back.ell_pattern is not None and back.ell_slots == 40
    np.testing.assert_array_equal(back.ell_indices, wide.ell_indices)
    np.testing.assert_array_equal(back.slot_of_bcsr, wide.slot_of_bcsr)


# --- the block-ELL partition ----------------------------------------------


@pytest.fixture(scope="module")
def banded():
    """(JAX BlockELL, port BlockELL) with the same random blocks on a long
    thin channel (a narrow band: 4 shards of 57 block rows hold 3 halos)."""
    jm = jbox.channel_mesh(24, 2, 2, length=4.0)
    jd = jas.build_discretization(jm, dtype=jnp.float64)
    jop, top = _operators(jd.indptr, jd.indices, seed=4)
    return jbell.bell_from_bcsr(jop), tbell.bell_from_bcsr(top)


def _device_mesh(P):
    return DeviceMesh(np.array(jax.devices()[:P]), ("x",))


@pytest.mark.parametrize("P", [2, 4])
def test_row_partition_equals_jax(banded, P):
    jell, tell = banded
    jp = jpart.build_row_partition(jell.indices, P)
    tp = tpart.build_row_partition(tell.indices, P)
    for field in ("n_devices", "rows_per_dev", "halo", "nb", "nb_pad",
                  "slots", "pad_diag_slot"):
        assert getattr(tp, field) == getattr(jp, field), field
    np.testing.assert_array_equal(tp.delta_indices, jp.delta_indices)
    assert tp.delta_indices.dtype == jp.delta_indices.dtype
    np.testing.assert_array_equal(
        tpart.pad_ell_values(tp, tell.values).numpy(),
        np.asarray(jpart.pad_ell_values(jp, jell.values)))


def test_row_partition_rejects_a_wide_band():
    """halo > L (a tiny mesh on 16 shards) and a band wider than the halo
    asked for raise the JAX package's ValueError."""
    jd = jas.build_discretization(jbox.channel_mesh(2, 2, 2),
                                  dtype=jnp.float64)
    with pytest.raises(ValueError, match="halo") as je:
        jpart.build_row_partition(jd.ell_indices, 16)
    with pytest.raises(ValueError, match="halo") as te:
        tpart.build_row_partition(jd.ell_indices, 16)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="bandwidth") as je:
        jpart.build_row_partition(jd.ell_indices, 2, halo=1)
    with pytest.raises(ValueError, match="bandwidth") as te:
        tpart.build_row_partition(jd.ell_indices, 2, halo=1)
    assert str(te.value) == str(je.value)


def _port_partitioned(tp, tell, x, P, **kw):
    """The port's partitioned product over [cpu] * P, joined back."""
    devices = [CPU] * P
    L = tp.rows_per_dev
    delta = tpart.split_rows(torch.as_tensor(tp.delta_indices), L, devices,
                             dim=0)
    vals = tpart.split_rows(tpart.pad_ell_values(tp, tell.values), L,
                            devices, dim=0)
    xs = tpart.split_rows(
        tpart.pad_vector(tp, torch.as_tensor(x)).reshape(-1, 4),
        L, devices, dim=0)
    if kw.get("k") is None:
        ys = tpart.partitioned_spmv(tp, delta, vals, xs)
    else:
        ys = tpart.partitioned_spmv_power(tp, delta, vals, xs, **kw)
    return tpart.join_rows(ys, tp.nb_pad, CPU, dim=0)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("k", [None, 2, 3])
def test_partitioned_products_match_jax(banded, P, k):
    """partitioned_spmv (k None) and partitioned_spmv_power (k = 2, 3)
    over P shards equal the JAX package's on P devices at rel 1e-12, and
    k chained single-device products; the pad rows act as identity."""
    jell, tell = banded
    jp = jpart.build_row_partition(jell.indices, P)
    tp = tpart.build_row_partition(tell.indices, P)
    assert (k or 1) * tp.halo <= tp.rows_per_dev
    x = np.random.default_rng(5).standard_normal(4 * jell.nb)
    dm = _device_mesh(P)
    args = (jp, dm, "x", jnp.asarray(jp.delta_indices),
            jpart.pad_ell_values(jp, jell.values),
            jpart.pad_vector(jp, jnp.asarray(x)))
    if k is None:
        y_j = np.asarray(jpart.partitioned_spmv(*args))
        y_t = _port_partitioned(tp, tell, x, P).reshape(-1).numpy()
    else:
        y_j = np.asarray(jpart.partitioned_spmv_power(*args, k))
        y_t = _port_partitioned(tp, tell, x, P, k=k).reshape(-1).numpy()
    assert y_t.shape == y_j.shape == (4 * tp.nb_pad,)
    assert _rel(y_t, y_j) <= REL
    y_ref = torch.as_tensor(x)
    idx = torch.as_tensor(tell.indices, dtype=torch.int64)
    for _ in range(k or 1):
        y_ref = tspmv.spmv_bell(idx, tell.values, y_ref)
    assert _rel(y_t[:4 * tp.nb], y_ref.numpy()) <= REL
    np.testing.assert_array_equal(y_t[4 * tp.nb:], 0.0)


def test_partitioned_power_basis_with_shifts_matches_jax(banded):
    """return_all with Newton-basis shifts: the (4 nb_pad, k) stack of
    prod_j (A - shifts[j] I) x equals the JAX package's at rel 1e-12."""
    jell, tell = banded
    P, k, shifts = 4, 3, (0.5, -1.25, 2.0)
    jp = jpart.build_row_partition(jell.indices, P)
    tp = tpart.build_row_partition(tell.indices, P)
    x = np.random.default_rng(6).standard_normal(4 * jell.nb)
    y_j = np.asarray(jpart.partitioned_spmv_power(
        jp, _device_mesh(P), "x", jnp.asarray(jp.delta_indices),
        jpart.pad_ell_values(jp, jell.values),
        jpart.pad_vector(jp, jnp.asarray(x)), k, return_all=True,
        shifts=shifts))
    y_t = _port_partitioned(tp, tell, x, P, k=k, return_all=True,
                            shifts=shifts)
    assert y_t.shape == (tp.nb_pad, 4, k)
    y_t = y_t.reshape(4 * tp.nb_pad, k).numpy()
    assert y_j.shape == y_t.shape
    assert _rel(y_t, y_j) <= REL
    with pytest.raises(ValueError, match="exceeds rows-per-device"):
        _port_partitioned(tp, tell, x, P, k=tp.rows_per_dev)
