"""The port's partitioned layer (`parallel/partitioned.py` of
navierstokes_tpu_torch) and the ghost-row forms of K1 and K2, against the
JAX package; then the distributed solver on the plane layout ('tlp',
dense and multilevel coarse), with the reference Jacobian, and the two
dryruns (`parallel/dryrun.py`).  The scalar paths are in
test_torch_distributed.py.

The port's shards all lie on the CPU (`[cpu] * P`); the JAX side runs on
conftest's 8 virtual CPU devices, its Pallas kernels in interpret mode.
Inputs are made with numpy from a seed and handed to both, in float64.
The integer layouts must be equal, the operators and the assembly agree
at rel 1e-12.  The ghost-row kernels themselves run only on the card
(`cuda` marker): there every shard's rows must equal the single-device
launch's rows bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as DeviceMesh

from navierstokes_tpu.fem import assembly as jas
from navierstokes_tpu.fem.dirichlet import zero_rows_bcsr
from navierstokes_tpu.mesh import channel_mesh as j_channel
from navierstokes_tpu.ops import pallas_dia as jpdia
from navierstokes_tpu.ops import plane_dia as jpd
from navierstokes_tpu.parallel import partitioned as jpart
from navierstokes_tpu.sparse.bcsr import BCSR4
from navierstokes_tpu.sparse.dia import dia_from_bcsr
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.fem.assembly import (
    FULL_JACOBIAN_TERMS,
    LINEAR_TERMS,
    assemble_dia_values,
    build_discretization,
    local_fields,
)
from navierstokes_tpu_torch.ops import band_ring
from navierstokes_tpu_torch.ops import dia as tdia
from navierstokes_tpu_torch.ops import plane_dia as tpd
from navierstokes_tpu_torch.parallel import dryrun
from navierstokes_tpu_torch.parallel import partitioned as tpart
from navierstokes_tpu_torch.solvers.vectors import Shards

from torch_distributed_cases import compare_with_jax

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jmesh(P):
    devs = jax.devices()
    assert len(devs) >= P, "conftest must provide 8 virtual CPU devices"
    return DeviceMesh(np.array(devs[:P]), ("x",))


@pytest.fixture(scope="module")
def banded():
    """The BC-applied linear operator of a long band-ordered channel in
    scalar-DIA form (tests/test_parallel.py's `banded_operator`)."""
    mesh = j_channel(48, 2, 2, length=8.0)
    disc = jas.build_discretization(mesh, dtype=jnp.float64)
    op = jas.assemble_operator(disc, jnp.zeros(disc.ndof), 0.01, 50.0, 0.1,
                               jas.LINEAR_TERMS)
    values = zero_rows_bcsr(op.values, disc.row_ids,
                            jnp.asarray(disc.indices), disc.diag_slots,
                            disc.bc.row_bc)
    dia = dia_from_bcsr(BCSR4(indptr=op.indptr, indices=op.indices,
                              values=values))
    return convert.scalar_dia_from_jax(dia)


# A narrow random DIA operator for the comparisons with the JAX package's
# partitioned functions: XLA unrolls one shifted multiply-add per diagonal
# and sweep, and compiles the 81 diagonals of a real operator slowly.
RAND_OFFSETS = (-7, -3, 0, 2, 7)


def _random_dia(seed, n=203):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal((len(RAND_OFFSETS), n))),
            rng)


def _scalar_layout(n, h, P, multiple=1):
    L = max(-(-n // P), h)
    return -(-L // multiple) * multiple


# -- the integer layouts ------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4, 8])
def test_element_partition_equals_jax(P):
    """`build_element_partition` on the port's discretization gives the JAX
    package's perm and local_map exactly."""
    jmesh = j_channel(12, 2, 2, length=6.0)
    jd = jas.build_discretization(jmesh, dtype=jnp.float64)
    td = build_discretization(convert.mesh_from_jax(jmesh), torch.float64,
                              CPU)
    halo = max(max(abs(o) for o in jd.dia_pattern.offsets), 1)
    je = jpart.build_element_partition(
        np.asarray(jd.mesh.tets), np.asarray(jd.dia_elem_map), jd.ndof,
        jd.dia_pattern.K, halo, P)
    te = tpart.build_element_partition(
        td.tets.numpy(), td.dia_elem_map.numpy(), td.ndof, td.dia_pattern.K,
        tpart.halo_of(td.dia_pattern.offsets), P)
    for field in ("n_devices", "L", "halo", "n_pad", "e_max", "K", "ndof"):
        assert getattr(te, field) == getattr(je, field), field
    np.testing.assert_array_equal(te.perm, je.perm)
    np.testing.assert_array_equal(te.local_map, je.local_map)


def test_exchange_fills_ghosts_from_neighbours():
    parts = [torch.arange(5.0) + 10 * s for s in range(3)]
    out = tpart.exchange(parts, 2)
    assert out[0].tolist() == [0, 0, 0, 1, 2, 3, 4, 10, 11]
    assert out[1].tolist() == [3, 4, 10, 11, 12, 13, 14, 20, 21]
    assert out[2].tolist() == [13, 14, 20, 21, 22, 23, 24, 0, 0]
    assert tpart.exchange(parts, 0) == parts


def test_partitioned_ops_reject_a_halo_wider_than_a_shard(banded):
    dia = banded
    n, h = dia.ndof, tpart.halo_of(dia.offsets)
    L = h - 1
    data = tpart.split_rows(dia.data, L, [CPU] * (-(-n // L)))
    x = tpart.split_rows(torch.ones(n, dtype=torch.float64), L,
                         [CPU] * (-(-n // L)))
    with pytest.raises(ValueError, match="exceeds rows-per-device"):
        tpart.partitioned_spmv_dia(dia.offsets, data, x)
    with pytest.raises(ValueError, match="exceeds rows-per-device"):
        tpart.partitioned_spmv_dia_power(dia.offsets, data, x, 2)


# -- the partitioned operators ------------------------------------------------


@pytest.mark.parametrize("P", [4, 8])
def test_partitioned_spmv_dia_matches_jax(banded, P):
    """Against the JAX package's `partitioned_spmv_dia` on a random narrow
    operator (data nonzero where i + off leaves the matrix); on the real
    operator, the rows of the single-device product bit for bit (the same
    terms in the same order; the ghosts hold the neighbours' values)."""
    data, rng = _random_dia(P)
    n, h = data.shape[1], tpart.halo_of(RAND_OFFSETS)
    L = _scalar_layout(n, h, P)
    x = rng.standard_normal(n)
    data_p = np.pad(data.numpy(), ((0, 0), (0, P * L - n)))
    y_jax = np.asarray(jpart.partitioned_spmv_dia(
        _jmesh(P), "x", RAND_OFFSETS, jnp.asarray(data_p),
        jnp.asarray(np.pad(x, (0, P * L - n))), P))[:n]
    devs = [CPU] * P
    y = tpart.join_rows(tpart.partitioned_spmv_dia(
        RAND_OFFSETS, tpart.split_rows(data, L, devs),
        tpart.split_rows(torch.as_tensor(x), L, devs)), n, CPU)
    assert _rel(y, y_jax) <= 1e-12

    dia = banded
    n = dia.ndof
    L = _scalar_layout(n, tpart.halo_of(dia.offsets), P)
    x = torch.as_tensor(rng.standard_normal(n))
    y = tpart.join_rows(tpart.partitioned_spmv_dia(
        dia.offsets, tpart.split_rows(dia.data, L, devs),
        tpart.split_rows(x, L, devs)), n, CPU)
    assert torch.equal(y, tdia.spmv_dia(dia.offsets, dia.data, x))


def _planes(dia, nb, noffs, n_out=4, n_in=4):
    p4 = tpd.extract_planes(dia.offsets, dia.data, nb, node_offsets=noffs)
    nd = len(noffs)
    if n_in == 4:
        return p4
    sel = [iD * 4 + b for iD in range(nd) for b in range(n_in)]
    return p4[:n_out][:, sel].contiguous()


@pytest.mark.parametrize("form", ["4x4", "3x3"])
def test_partitioned_spmv_plane_matches_jax(banded, form):
    """4x4 against the JAX package's `partitioned_spmv_plane` (8 devices,
    tiled planes), 3x3 against its `spmv_planes_pallas` on the whole
    vector; the port's shards use its own layout (Lb nodes per shard)."""
    dia, P = banded, 8
    nb = dia.ndof // 4
    noffs = tpd.node_offsets_from_scalar(dia.offsets)
    n = int(form[0])
    planes = _planes(dia, nb, noffs, n, n)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, nb))
    if form == "4x4":
        tile = 512
        hn = tpart.halo_of(noffs)
        Lb_j = -(-max(-(-nb // P), hn) // tile) * tile
        tiled = jpd.pretile_planes(jnp.asarray(planes.numpy()), nb,
                                   tile=tile, nbp=P * Lb_j)
        xj = np.zeros((4, P * Lb_j))
        xj[:, :nb] = x
        y_jax = np.asarray(jpart.partitioned_spmv_plane(
            _jmesh(P), "x", noffs, tiled, jnp.asarray(xj.reshape(-1)), P))
        y_jax = y_jax.reshape(4, -1)[:, :nb]
    else:
        tile = 1024
        tiled = jpd.pretile_planes(jnp.asarray(planes.numpy()), nb,
                                   tile=tile)
        nbp = tiled.shape[0] * tile
        xj = np.zeros((n, nbp))
        xj[:, :nb] = x
        y_jax = np.asarray(jpd.spmv_planes_pallas(
            noffs, tiled, jnp.asarray(xj.reshape(-1)), n_in=n, nb=nb,
            interpret=True)).reshape(n, nbp)[:, :nb]

    Lb = -(-max(-(-nb // P), tpart.halo_of(noffs)) // 2) * 2
    devs = [CPU] * P
    data = tpart.split_rows(planes, Lb, devs)
    xs = tpart.split_rows(torch.as_tensor(x), Lb, devs)
    ys = tpart.partitioned_spmv_plane(
        noffs, data, Shards(a.reshape(-1) for a in xs.parts), nb=nb, n_in=n)
    # the padding rows of the last shard are exact zeros
    assert torch.all(ys.parts[-1].reshape(n, Lb)[:, nb - (P - 1) * Lb:] == 0)
    y = tpart.join_rows(Shards(a.reshape(n, -1) for a in ys.parts), nb, CPU)
    assert _rel(y, y_jax) <= 1e-12
    single = tpd.spmv_planes(noffs, planes, torch.as_tensor(x).reshape(-1),
                             n_in=n, nb=nb).reshape(n, nb)
    assert torch.equal(y, single)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_partitioned_power_matches_jax(banded, k):
    """The one-exchange power sweep against the JAX package's on a random
    narrow operator, with and without shifts, the last power and the whole
    stack; on the real operator, the stack's columns against k chained
    single-device K2 applies."""
    P = 4
    data, rng = _random_dia(20 + k)
    n, h = data.shape[1], tpart.halo_of(RAND_OFFSETS)
    L = _scalar_layout(n, k * h, P)
    x = rng.standard_normal(n)
    shifts = tuple(float(s) for s in rng.uniform(0.5, 1.5, k))
    data_p = jnp.asarray(np.pad(data.numpy(), ((0, 0), (0, P * L - n))))
    xp = jnp.asarray(np.pad(x, (0, P * L - n)))
    devs = [CPU] * P
    parts = tpart.split_rows(data, L, devs)
    xs = tpart.split_rows(torch.as_tensor(x), L, devs)
    for return_all, sh in ((False, None), (True, None), (True, shifts)):
        want = np.asarray(jax.jit(functools.partial(
            jpart.partitioned_spmv_dia_power, _jmesh(P), "x", RAND_OFFSETS,
            n_devices=P, k=k, return_all=return_all, shifts=sh))(
                data_p, xp))[:n]
        got = tpart.partitioned_spmv_dia_power(
            RAND_OFFSETS, parts, xs, k, return_all=return_all, shifts=sh)
        got = torch.cat(got.parts)[:n]
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-12

    dia = banded
    n = dia.ndof
    L = _scalar_layout(n, k * tpart.halo_of(dia.offsets), 2)
    cur = torch.as_tensor(rng.standard_normal(n))
    stack = torch.cat(tpart.partitioned_spmv_dia_power(
        dia.offsets, tpart.split_rows(dia.data, L, devs[:2]),
        tpart.split_rows(cur, L, devs[:2]), k, return_all=True).parts)[:n]
    for j in range(k):
        cur = tdia.spmv_dia(dia.offsets, dia.data, cur)
        assert _rel(stack[:, j], cur) <= 1e-12


# -- the partitioned assembly -------------------------------------------------


@pytest.mark.parametrize("terms", ["linear", "full"])
def test_partitioned_assembly_matches_jax_and_global(terms):
    """Against the JAX package's `partitioned_assemble_dia` (the full
    Jacobian's terms, which hold the linear ones: XLA compiles each term
    set anew) and, for both term sets, the port's global assembly."""
    P = 4
    jmesh = j_channel(12, 2, 2, length=6.0)
    jd = jas.build_discretization(jmesh, dtype=jnp.float64)
    td = build_discretization(convert.mesh_from_jax(jmesh), torch.float64,
                              CPU)
    halo = max(max(abs(o) for o in jd.dia_pattern.offsets), 1)
    je = jpart.build_element_partition(
        np.asarray(jd.mesh.tets), np.asarray(jd.dia_elem_map), jd.ndof,
        jd.dia_pattern.K, halo, P)
    te = tpart.build_element_partition(
        td.tets.numpy(), td.dia_elem_map.numpy(), td.ndof, td.dia_pattern.K,
        halo, P)
    u = np.random.default_rng(7).standard_normal(jd.ndof)
    jterms = jas.LINEAR_TERMS if terms == "linear" else \
        jas.FULL_JACOBIAN_TERMS
    tterms = LINEAR_TERMS if terms == "linear" else FULL_JACOBIAN_TERMS
    perm = je.perm
    UL = local_fields(td.tets, torch.as_tensor(u))[0]
    arrays = tpart.shard_element_arrays(te, td.vol, td.grad, td.h, [CPU] * P)
    parts = tpart.partitioned_assemble_dia(te, arrays, 0.01, 100.0, 0.1,
                                           terms=tterms, UL=UL)
    got = torch.cat(parts.parts, dim=1)
    assert got.shape == (td.dia_pattern.K, te.n_pad)
    if terms == "full":
        UL_j = jas.local_fields(jd.tets, jnp.asarray(u))[0]
        want = np.asarray(jax.jit(functools.partial(
            jpart.partitioned_assemble_dia, je, _jmesh(P), "x",
            dt=0.01, reynolds=100.0, delta=0.1, terms=jterms))(
                jnp.asarray(np.asarray(jd.grad)[perm]),
                jnp.asarray(np.asarray(jd.vol)[perm]),
                jnp.asarray(np.asarray(jd.h)[perm]), UL_j[perm],
                jnp.asarray(je.local_map)))
        assert _rel(got, want) <= 1e-12
    ref = assemble_dia_values(td.vol, td.grad, td.h, 0.01, 100.0, 0.1,
                              td.dia_elem_map, terms=tterms,
                              K=td.dia_pattern.K, ndof=td.ndof, UL=UL)
    assert _rel(got[:, :td.ndof], ref) <= 1e-12


# -- the ghost-row forms of K1 and K2 (plain versions) -----------------------


def _ghosted(rng, planes_shape, h, g, n_in, nbp):
    """x planes with g ghost rows per side, random where the JAX layout's
    h ghost rows are (nonzero ghosts), zero in the extra g - h."""
    xh = rng.standard_normal((n_in, nbp + 2 * h))
    xg = np.zeros((n_in, nbp + 2 * g))
    xg[:, g - h:g + nbp + h] = xh
    return xh, xg


@pytest.mark.parametrize("n_out,n_in", [(4, 4), (3, 3)])
def test_plane_plain_ghost_rows_match_jax_prehalo(n_out, n_in):
    """spmv_planes_plain with ghost rows == the JAX package's
    spmv_planes_pallas(x_prehalo=True) in interpret mode, on random
    operator data and ghost rows; with the ghost width rounded up
    (`ghost_width`) too."""
    noffs = (-9, -5, -1, 0, 1, 3, 9)
    rng = np.random.default_rng(31 + n_out)
    nb, tile = 700, 256
    nbp = 3 * tile
    planes = rng.standard_normal((n_out, n_in * len(noffs), nbp))
    planes[:, :, nb:] = 0
    h = tpart.halo_of(noffs)
    g = tpd.ghost_width(noffs, 8)
    assert g == 10 and g % 2 == 0
    xh, xg = _ghosted(rng, planes.shape, h, g, n_in, nbp)
    tiled = jpd.pretile_planes(jnp.asarray(planes), nbp, tile=tile, nbp=nbp)
    want = np.asarray(jpd.spmv_planes_pallas(
        noffs, tiled, jnp.asarray(xh.reshape(-1)), n_in=n_in, nb=nb,
        interpret=True, x_prehalo=True))
    data = torch.as_tensor(planes)
    for halo, x in ((h, xh), (g, xg)):
        got = tpd.spmv_planes(noffs, data, torch.as_tensor(x.reshape(-1)),
                              n_in=n_in, nb=nb, halo=halo)
        assert _rel(got, want) <= 1e-12
        assert torch.all(got.reshape(n_out, nbp)[:, nb:] == 0)


@pytest.mark.parametrize("data_dtype,x_dtype,bar", [
    (torch.float64, torch.float64, 1e-12),
    (torch.bfloat16, torch.float64, 1e-12),
])
def test_dia_plain_ghost_rows_match_jax_prehalo(banded, data_dtype, x_dtype,
                                                bar):
    """spmv_dia_plain with ghost rows == the JAX package's spmv_dia_pallas
    (pretiled data, x_prehalo=True) in interpret mode, on random data and
    ghost rows (f64, and bf16 operator data with f64 x)."""
    offsets = banded.offsets
    rng = np.random.default_rng(41)
    n, tile = 900, 512
    h = tpart.halo_of(offsets)
    data = torch.as_tensor(rng.standard_normal((len(offsets), n))).to(
        data_dtype)
    x = rng.standard_normal(n + 2 * h)
    d_np = convert.state_to_numpy(data.float()) if data_dtype == \
        torch.bfloat16 else data.numpy()
    jdata = jnp.asarray(d_np, dtype=jnp.bfloat16 if data_dtype ==
                        torch.bfloat16 else jnp.float64)
    want = np.asarray(jpdia.spmv_dia_pallas(
        offsets, jpdia.pretile_dia(jdata, n, tile=tile), jnp.asarray(x),
        n=n, x_prehalo=True, interpret=True))
    got = tdia.spmv_dia(offsets, data, torch.as_tensor(x).to(x_dtype),
                        halo=h)
    assert got.dtype == x_dtype
    assert _rel(got, want) <= bar


def test_ghost_width_and_route_rule():
    """The stored ghost width is the node halo rounded up to 16 bytes; the
    tiled route takes a ghost width only on 16 bytes, and a shard of matrix
    6's four-way layout (7,344 nodes, halo 651) fits it in f32 and f64."""
    noffs = tuple(range(-651, 652, 93))
    assert tpd.ghost_width(noffs, 4) == 652
    assert tpd.ghost_width(noffs, 8) == 652
    assert tpd.ghost_width((0,), 4) == 4
    for itemsize in (4, 8):
        assert tpd.tile_plan(noffs, 4, 4, 7344, itemsize, halo=652)
        assert tpd.tile_plan(noffs, 4, 4, 7344, itemsize, halo=651) is None
    data = torch.zeros((4, 4 * len(noffs), 7344))
    x = torch.zeros(4 * (7344 + 2 * 652))
    assert tpd.plane_route(noffs, data, x, 4, halo=652) == "tiled"
    x = torch.zeros(4 * (7344 + 2 * 651))
    assert tpd.plane_route(noffs, data, x, 4, halo=651) == "rows"
    assert band_ring.COPY_ALIGN == 16


def test_wrappers_reject_a_narrow_ghost_width():
    data = torch.zeros((4, 8, 64), dtype=torch.float64)
    with pytest.raises(ValueError, match="ghost width"):
        tpd.spmv_planes_plain((-1, 2), data, torch.zeros(4 * 66), n_in=4,
                              nb=64, halo=1)
    with pytest.raises(ValueError, match="x has shape"):
        tpd.spmv_planes_plain((-1, 2), data, torch.zeros(4 * 66), n_in=4,
                              nb=64, halo=2)
    with pytest.raises(ValueError, match="ghost width"):
        tdia.spmv_dia_plain((-3, 0, 3), torch.zeros((3, 10)),
                            torch.zeros(14), halo=2)
    with pytest.raises(ValueError, match="x has shape"):
        tdia.spmv_dia_plain((-3, 0, 3), torch.zeros((3, 10)),
                            torch.zeros(14), halo=3)


def test_cpu_ghost_forms_count_plain_only(banded):
    dia, P = banded, 4
    L = _scalar_layout(dia.ndof, tpart.halo_of(dia.offsets), P)
    devs = [CPU] * P
    x = torch.ones(dia.ndof, dtype=torch.float64)
    tdia.reset_counters()
    tpart.partitioned_spmv_dia(dia.offsets,
                               tpart.split_rows(dia.data, L, devs),
                               tpart.split_rows(x, L, devs))
    assert tdia.plain_calls == P
    assert tdia.kernel_launches == tdia.halo_launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ghost_kernels_equal_single_device_rows_on_the_card(banded, dtype):
    """On the card: each shard's ghost-row K1 (both routes where they fit)
    and K2 launch give the rows of the single-device launch on the whole
    vector bit for bit, and match their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    dia = banded
    P = 4
    data = dia.data.to(dev, dtype)
    n = dia.ndof
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(n)).to(
        dev, dtype)
    L = _scalar_layout(n, tpart.halo_of(dia.offsets), P)
    devs = [dev] * P
    tdia.reset_counters()
    y = tpart.join_rows(tpart.partitioned_spmv_dia(
        dia.offsets, tpart.split_rows(data, L, devs),
        tpart.split_rows(x, L, devs)), n, dev)
    assert tdia.halo_launches == P
    assert torch.equal(y, tdia.spmv_dia(dia.offsets, data, x))

    nb = n // 4
    noffs = tpd.node_offsets_from_scalar(dia.offsets)
    planes = tpd.extract_planes(dia.offsets, data, nb, node_offsets=noffs)
    unit = 16 // data.element_size()
    Lb = -(-max(-(-nb // P), tpart.halo_of(noffs)) // unit) * unit
    xp = tpd.to_planes(x, nb, nb).reshape(4, nb)
    whole = tpd.spmv_planes(noffs, planes, xp.reshape(-1), n_in=4, nb=nb)
    xs = tpart.split_rows(xp, Lb, devs)
    ys = tpart.partitioned_spmv_plane(
        noffs, tpart.split_rows(planes, Lb, devs),
        Shards(a.reshape(-1) for a in xs.parts), nb=nb)
    got = tpart.join_rows(Shards(a.reshape(4, -1) for a in ys.parts), nb,
                          dev)
    assert torch.equal(got, whole.reshape(4, nb))


# -- the distributed solver on the plane layout ------------------------------


@pytest.mark.parametrize("krylov_kw", [
    dict(preconditioner="two_level", coarse_agg=4, spmv="plane"),
    dict(preconditioner="two_level", coarse_agg=4, spmv="plane",
         coarse_dense_max=32),
], ids=["tlp-dense", "tlp-multilevel"])
def test_plane_path_matches_jax_and_single_device(krylov_kw):
    """'tlp' with the dense and the multilevel coarse level against the JAX
    package's distributed solver and the port's single-device solver
    (tests/test_parallel.py:316, 459, 490)."""
    compare_with_jax(krylov_kw)


def test_reference_jacobian_matches_jax_and_single_device():
    """jacobian='reference': every Newton iteration assembles the
    convection terms per shard (partitioned assembly) and prepares the
    operator anew; the element-wise residual runs in the global view."""
    stats = compare_with_jax(
        dict(preconditioner="two_level", coarse_agg=4),
        cfg_kw=dict(jacobian="reference", residual="element"), steps=2)
    assert all(st.iters >= 2 for st in stats)


def test_dryruns_on_the_cpu():
    """The port's copies of the two multi-device checks of
    `__graft_entry__.py`, four shards on the CPU: one float32 step through
    K1's ghost-row form, and matrix 4 in float64 against one device (rel
    1e-8, Newton equal, GMRES within 2)."""
    out = dryrun.dryrun_multichip(4, "cpu")
    assert out["newton"] >= 1
    wide = dryrun.dryrun_wide(4, "cpu")
    assert wide["rel"] < 1e-8
    assert abs(wide["gmres"] - wide["gmres_single"]) <= 2
