"""The port's fused CGS2 projection (ops/cgs2.py, kernel K3) and its GMRES
and model wiring against the JAX package's (ops/cgs2_pallas.py).

On the CPU the port's wrapper runs K3's plain version; the JAX side runs
the Pallas kernels in interpret mode, as the JAX package's own tests do.
The JAX kernel needs V padded to 8-row blocks and n a tile multiple; the
port takes its unpadded (m+1, n) basis and any n.  Inputs are made with
numpy from a seed, in float64.  The kernel itself runs only on the card
(`cuda` marker).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.config import NSConfig as JNS
from navierstokes_tpu.config import SolverConfig as JSolver
from navierstokes_tpu.mesh import channel_mesh as j_channel
from navierstokes_tpu.model import NavierStokesSolver as JSolverModel
from navierstokes_tpu.ops.cgs2_pallas import cgs2_project as j_cgs2_project
from navierstokes_tpu.solvers.gmres import gmres as j_gmres
from navierstokes_tpu_torch import convert, run
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.ops import cgs2 as tcgs2
from navierstokes_tpu_torch.ops import cuda_lib, grid_sync
from navierstokes_tpu_torch.ops.band_ring import SMEM_LIMIT
from navierstokes_tpu_torch.solvers.gmres import gmres

torch.set_num_threads(1)
CPU = torch.device("cpu")
M1, N = 31, 1024          # restart 30: 31 basis rows; the JAX V pads to 32


@functools.cache
def _jax_project(tile: int, compensated: bool):
    return jax.jit(lambda V, w, k: j_cgs2_project(
        V, w, k, tile=tile, interpret=True, compensated=compensated))


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _basis(k: int, seed: int):
    """Orthonormal rows 0..k (the GMRES invariant), zeros above."""
    rng = np.random.default_rng(seed)
    V = np.zeros((M1, N))
    V[:k + 1] = np.linalg.qr(rng.standard_normal((N, k + 1)))[0].T
    return V, rng.standard_normal(N)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("k,tile", [(0, 128), (1, 256), (7, 128), (8, 256),
                                    (13, 128), (30, 256)])
def test_plain_matches_jax_kernel(k, tile, compensated):
    """cgs2_project_plain == the JAX kernel (interpret mode, V padded to 32
    rows) at rtol 1e-12, with h exactly zero beyond k."""
    V, w = _basis(k, seed=k)
    Vj = np.zeros((32, N))
    Vj[:M1] = V
    w2_j, h_j = _jax_project(tile, compensated)(jnp.asarray(Vj),
                                                jnp.asarray(w), k)
    tcgs2.reset_counters()
    w2, h = tcgs2.cgs2_project(torch.as_tensor(V), torch.as_tensor(w), k,
                               compensated=compensated)
    assert tcgs2.plain_calls == 1 and tcgs2.kernel_launches == 0
    assert h.shape == (M1,) and w2.dtype == torch.float64
    np.testing.assert_allclose(w2.numpy(), np.asarray(w2_j), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j)[:M1], rtol=1e-12,
                               atol=1e-12)
    assert np.all(h.numpy()[k + 1:] == 0.0)


def test_stale_nan_rows_do_not_leak():
    """Rows above k are never read: NaN there leaves w2 finite and h beyond
    k exactly zero, in the port as in the JAX kernel."""
    rng = np.random.default_rng(7)
    V = rng.standard_normal((M1, N))
    V[5:] = np.nan
    w = rng.standard_normal(N)
    w2, h = tcgs2.cgs2_project(torch.as_tensor(V), torch.as_tensor(w), 4)
    Vj = np.full((32, N), np.nan)
    Vj[:5] = V[:5]
    w2_j, h_j = _jax_project(256, False)(jnp.asarray(Vj), jnp.asarray(w), 4)
    assert np.all(np.isfinite(w2.numpy())) and np.all(h.numpy()[5:] == 0.0)
    np.testing.assert_allclose(w2.numpy(), np.asarray(w2_j), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j)[:M1], rtol=1e-12,
                               atol=1e-12)


def test_plain_float32_accumulates_in_float32():
    V, w = _basis(9, seed=3)
    V32, w32 = (torch.as_tensor(a, dtype=torch.float32) for a in (V, w))
    for comp in (False, True):
        w2, h = tcgs2.cgs2_project(V32, w32, 9, compensated=comp)
        w2_64, h_64 = tcgs2.cgs2_project(V32.double(), w32.double(), 9)
        assert w2.dtype == h.dtype == torch.float32
        assert float(torch.linalg.norm(w2.double() - w2_64)
                     / torch.linalg.norm(w2_64)) < 1e-6
        assert float(torch.linalg.norm(h.double() - h_64)
                     / torch.linalg.norm(h_64)) < 1e-6


@pytest.mark.parametrize("grid", [132, 16])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_slab_split_covers_n(grid, itemsize):
    """grid_sync's slabs cover [0, n) in order, disjoint, with every cut on
    16 bytes, none longer than max_slab (the row stride in shared memory)
    and none more than 16 bytes shorter than another, for ragged n and
    n smaller than the grid."""
    align = 16 // itemsize
    for n in (1, 3, 17, 10_007, 117_500, 117_760, 511_024, 1_000_003):
        cuts = grid_sync.slab_cuts(n, grid, itemsize)
        assert cuts[0] == 0 and cuts[-1] == n and len(cuts) == grid + 1
        sizes = [b - a for a, b in zip(cuts, cuts[1:])]
        assert min(sizes) >= 0
        assert all(c % align == 0 for c in cuts[:-1])
        assert max(sizes) <= grid_sync.max_slab(n, grid, itemsize)
        assert max(sizes) - min(sizes) < 2 * align or n < grid * align
    assert grid_sync.max_slab(117_760, 132, 4) == 896
    assert grid_sync.max_slab(117_500, 132, 8) == 892


def test_plan_fits_the_opt_in():
    """K3's plan: h1, h2, w1's slab and the R resident rows fit the 227 KB
    opt-in at every k <= 511 in f32 and f64, R = k+1 wherever the rows fit,
    and the matrix-6 GMRES shapes keep all of V[:k+1] (up to 30 rows of
    892 f64 values, 214 KB) resident; at the Schur tier's n and above, R
    drops below k+1."""
    for n in (1_024, 117_760, 511_024, 1_000_003, 4_000_000):
        for item in (4, 8):
            for k in range(512):
                pl = tcgs2.plan(n, k, item)
                row = pl.ld * item
                assert pl.smem <= SMEM_LIMIT
                assert 0 <= pl.rows <= k + 1
                assert pl.rows == k + 1 or pl.smem + row > SMEM_LIMIT
                assert pl.smem == (tcgs2.HEADER_BYTES
                                   + -(-2 * (k + 1) * item // 16) * 16
                                   + (row if pl.w1_shared else 0)
                                   + pl.rows * row)
    assert tcgs2.plan(117_760, 15, 4).rows == 16
    assert tcgs2.plan(117_760, 29, 4).rows == 30
    f64 = tcgs2.plan(117_500, 29, 8)
    assert f64.rows == 30 and f64.w1_shared and f64.ld == 892
    assert 30 * 892 * 8 == 214_080 <= f64.smem <= SMEM_LIMIT
    assert tcgs2.plan(511_024, 29, 4).rows == 13
    assert tcgs2.plan(1_000_003, 29, 8).rows == 2
    assert not tcgs2.plan(8_000_000, 0, 8).w1_shared


def test_passes_over_v_counts_the_rereads():
    """The bench's model of K3's reads of V[:k+1]: once where every live
    row is resident, three times (three separate sweeps) where none is."""
    assert tcgs2.passes_over_v(29, 30) == 1.0
    assert tcgs2.passes_over_v(29, 0) == 3.0
    assert tcgs2.passes_over_v(29, 13) == (13 + 3 * 17) / 30
    pl = tcgs2.plan(511_024, 29, 4)
    assert 1.0 < tcgs2.passes_over_v(29, pl.rows) < 3.0


def test_one_cooperative_launch_per_projection():
    """csrc/cgs2.cu makes one cooperative launch per projection, and no
    plain launch, so the wrapper counts LAUNCHES == 1 per call; the
    constants the wrapper mirrors match the source."""
    src = (cuda_lib.CSRC / "cgs2.cu").read_text()
    assert "<<<" not in src
    body = src[src.index("int launch_one("):src.index("int launch(")]
    assert body.count("grid_sync::launch(") == 1 == tcgs2.LAUNCHES
    assert src.count("grid_sync::launch(") == 1
    assert "constexpr int kMaxRows = 512;" in src
    assert f"constexpr int kHeaderBytes = {tcgs2.HEADER_BYTES};" in src
    header = (cuda_lib.CSRC / "grid_sync.cuh").read_text()
    assert "cudaLaunchCooperativeKernel" in header
    assert cuda_lib.CSRC / "grid_sync.cuh" in cuda_lib.source_files("cgs2")


def test_wrapper_rejects_what_it_cannot_take():
    V = torch.zeros(M1, 64, dtype=torch.float64)
    w = torch.zeros(64, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tcgs2.cgs2_project_cuda(V, w, 3)
    with pytest.raises(ValueError, match="row bound"):
        tcgs2.cgs2_project(V, w, M1)
    with pytest.raises(ValueError, match="shape"):
        tcgs2.cgs2_project(V, w[:-1], 3)
    with pytest.raises(TypeError, match="dtype"):
        tcgs2.cgs2_project(V, w.float(), 3)
    with pytest.raises(ValueError, match="m1, n"):
        tcgs2.cgs2_project(V[0], w, 0)


def _dense_system(n, seed, scale, shift):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * shift + scale * rng.standard_normal((n, n))
    return A, rng.standard_normal(n)


def test_gmres_cgs2_kernel_matches_jax():
    """The dense n = 1024 system of the JAX package's own test: the port's
    gmres(cgs2_kernel=True) and the JAX one (Pallas in interpret mode,
    tile 512) take the same iterations, x at rel 1e-10."""
    n = 1024
    rng = np.random.default_rng(3)
    A = np.eye(n) * 4.0 + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    kw = dict(restart=30, rtol=1e-12, atol=1e-14, maxiter=300)
    res_j = j_gmres(lambda x: jnp.matmul(
        Aj, x, precision=jax.lax.Precision.HIGHEST), jnp.asarray(b),
        cgs2_kernel=True, cgs2_tile=512, **kw)
    At = torch.as_tensor(A)
    tcgs2.reset_counters()
    res = gmres(lambda x: At @ x, torch.as_tensor(b), cgs2_kernel=True, **kw)
    assert tcgs2.plain_calls == res.iters
    assert res.converged and bool(res_j.converged)
    assert res.iters == int(res_j.iters)
    x_np = np.linalg.solve(A, b)
    for x in (res.x.numpy(), np.asarray(res_j.x)):
        assert np.linalg.norm(x - x_np) / np.linalg.norm(x_np) < 1e-10
    assert np.linalg.norm(res.x.numpy() - np.asarray(res_j.x)) \
        / np.linalg.norm(x_np) < 1e-10


@pytest.mark.parametrize("compensated", [False, True])
def test_gmres_cgs2_kernel_takes_any_n(compensated):
    """n = 700 is no tile multiple: the JAX package falls back to XLA
    there; the port goes through K3's plain version (no fallback), and
    matches its own four-GEMV path."""
    A, b = _dense_system(700, 9, 0.1, 3.0)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    kw = dict(rtol=1e-10, atol=1e-12, maxiter=200)
    tcgs2.reset_counters()
    res = gmres(lambda x: At @ x, bt, cgs2_kernel=True,
                cgs2_compensated=compensated, **kw)
    assert res.converged and tcgs2.plain_calls == res.iters > 0
    ref = gmres(lambda x: At @ x, bt, **kw)
    assert res.iters == ref.iters
    assert np.linalg.norm(A @ res.x.numpy() - b) <= 1e-9 * np.linalg.norm(b)
    assert float(torch.linalg.norm(res.x - ref.x)
                 / torch.linalg.norm(ref.x)) < 1e-10


@pytest.mark.parametrize("krylov_kw,kind", [
    (dict(preconditioner="two_level", spmv="plane"), "tlp"),
    (dict(preconditioner="block_jacobi"), "bj"),
])
def test_model_with_fused_cgs2_matches_jax(krylov_kw, kind):
    """NavierStokesSolver with cgs2='pallas' and 'pallas_comp' on
    channel(6,3,3) with an obstacle, f64: the Stokes solve equals the
    port's cgs2='xla' one (rel 1e-9, the same GMRES count), and 2 steps
    from the JAX model's states equal the JAX model's with the same config
    (rel 1e-9, identical Newton and GMRES counts).  At this size (n = 448)
    n is no multiple of the JAX kernel's 4096 tile, so the JAX model runs
    its XLA projection; the algebra is the same.  The port's solves all go
    through K3's plain version."""
    kr = JSolver(rtol=1e-12, atol=1e-13, maxiter=4000, cgs2="pallas",
                 **krylov_kw)
    jcfg = JNS(dt=0.01, t_final=0.02, reynolds=100.0, delta=0.1,
               dtype="float64", krylov=kr, stokes_krylov=kr)
    jmesh = j_channel(6, 3, 3, obstacle=True)
    js = JSolverModel(jmesh, jcfg)
    tcfg = convert.config_from_jax(jcfg)
    ports = {}
    for cgs2 in ("xla", "pallas", "pallas_comp"):
        tk = dataclasses.replace(tcfg.krylov, cgs2=cgs2)
        ports[cgs2] = NavierStokesSolver(
            convert.mesh_from_jax(jmesh),
            dataclasses.replace(tcfg, krylov=tk, stokes_krylov=tk),
            device=CPU)
        assert ports[cgs2].prep_kind == kind
    u_xla = ports["xla"].stokes_init()
    tcgs2.reset_counters()
    fused = {c: ports[c] for c in ("pallas", "pallas_comp")}
    for ts in fused.values():
        u0 = ts.stokes_init()
        assert ts.stokes_result.converged
        assert ts.stokes_result.iters == ports["xla"].stokes_result.iters
        assert _rel(u0.numpy(), u_xla.numpy()) <= 1e-9
    u_old, du = u_xla.numpy(), np.zeros(u_xla.shape[0])
    for _ in range(2):
        uj1, duj, sj = js.step(jnp.asarray(u_old), jnp.asarray(u_old),
                               jnp.asarray(du))
        assert bool(sj.converged)
        for ts in fused.values():
            ut1, _, st = ts.step(torch.as_tensor(u_old),
                                 torch.as_tensor(u_old), torch.as_tensor(du))
            assert st.converged
            assert st.iters == int(sj.iters)
            assert st.lin_iters == int(sj.lin_iters)
            assert _rel(ut1.numpy(), np.asarray(uj1)) <= 1e-9
        u_old, du = np.array(uj1), np.array(duj)
    assert tcgs2.plain_calls > 0 and tcgs2.kernel_launches == 0


def test_cli_cgs2_pallas_on_cpu():
    """`run.main --cgs2 pallas --device cpu`: the f64 default ('bj') with
    every GMRES iteration through K3's plain version."""
    tcgs2.reset_counters()
    out = run.main(["--nx", "4", "--ny", "2", "--nz", "2", "--steps", "2",
                    "--device", "cpu", "--cgs2", "pallas"])
    s = out.solver
    assert s.cfg.krylov.cgs2 == s.cfg.stokes_krylov.cgs2 == "pallas"
    assert s.prep_kind == "bj" and s.stokes_result.converged
    assert all(st.converged for _, st, _ in s.history)
    assert tcgs2.plain_calls > 0 and tcgs2.kernel_launches == 0


def _card_basis(rng, n, dtype, rows=M1):
    """Orthonormal rows 0..rows-2 (as GMRES keeps them) and a w, on the
    card."""
    q = np.linalg.qr(rng.standard_normal((n, rows - 1)))[0].T
    V = torch.zeros((rows, n), dtype=dtype, device="cuda")
    V[:rows - 1] = torch.as_tensor(q, dtype=dtype)
    w = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device="cuda")
    return V, w


def _check_on_card(V, w, k, comp, bar, repeats=1):
    """K3 on V with NaN rows above k against its plain version on the clean
    V: rel within `bar`, h beyond k exactly 0, `repeats` calls equal bit
    for bit."""
    poisoned = V.clone()
    poisoned[k + 1:] = float("nan")
    w2, h = tcgs2.cgs2_project(poisoned, w, k, compensated=comp)
    torch.cuda.synchronize()
    w2_r, h_r = tcgs2.cgs2_project_plain(V, w, k, compensated=comp)
    for got, want in ((w2, w2_r), (h, h_r)):
        err = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        assert err <= bar, (V.dtype, V.shape, k, comp, err)
    assert bool((h[k + 1:] == 0).all())
    for _ in range(repeats - 1):
        again = tcgs2.cgs2_project(poisoned, w, k, compensated=comp)
        assert torch.equal(again[0], w2) and torch.equal(again[1], h)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """K3 against its plain version on the card: f32 at rel 1e-5, f64 at
    rel 1e-12, for n with bulk copies (n * itemsize a multiple of 16) and
    without, and several k, plain and compensated; h beyond k exactly zero,
    NaN rows above k ignored."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 has no CPU or interpret mode")
    rng = np.random.default_rng(11)
    for n in (10_007, 117_760):
        for dtype, bar in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            V, w = _card_basis(rng, n, dtype)
            for k in (0, 5, 15, 29):
                for comp in (False, True):
                    _check_on_card(V, w, k, comp, bar)


@pytest.mark.cuda
def test_kernel_rereads_rows_that_do_not_fit_on_the_card():
    """Where V[:k+1]'s slab does not fit in shared memory (R < k+1: the
    rows above R are read again from global memory in every phase), K3
    still matches its plain version: n = 1,000,003 in f64 (no bulk copies,
    R = 2) and n = 511,024 in f32 (the Schur tier's size, bulk copies,
    R = 13), k = 29, 50 calls each equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 has no CPU or interpret mode")
    rng = np.random.default_rng(13)
    for n, dtype, bar in ((1_000_003, torch.float64, 1e-12),
                          (511_024, torch.float32, 1e-5)):
        assert tcgs2.plan(n, 29, torch.empty((), dtype=dtype)
                          .element_size()).rows < 30
        V, w = _card_basis(rng, n, dtype)
        for comp in (False, True):
            _check_on_card(V, w, 29, comp, bar, repeats=50)


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit_on_the_card():
    """50 calls of K3 at the matrix-6 GMRES shapes give the same bits: the
    partials that other blocks fold after a grid barrier are never read
    stale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 has no CPU or interpret mode")
    rng = np.random.default_rng(14)
    for n, dtype, bar in ((117_760, torch.float32, 1e-5),
                          (117_500, torch.float64, 1e-12)):
        V, w = _card_basis(rng, n, dtype)
        for k in (15, 29):
            for comp in (False, True):
                _check_on_card(V, w, k, comp, bar, repeats=50)


def test_every_kernel_source_is_listed():
    """`cuda_lib.SOURCES` names every csrc/*.cu (K1-K4), so the parallel
    build of `chip_smoke.py` covers them all."""
    assert sorted(p.stem for p in cuda_lib.CSRC.glob("*.cu")) \
        == sorted(cuda_lib.SOURCES)
