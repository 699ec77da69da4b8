"""The ported slice as a whole: the flagship transient solve of the PyTorch
package against the JAX package, the golden trajectory, the `.dat`
writer, the CLI, and the options outside the slice."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.config import NSConfig as JNS
from navierstokes_tpu.config import SolverConfig as JSolver
from navierstokes_tpu.io.dat import write_petsc_vec as j_write
from navierstokes_tpu.mesh import channel_mesh as j_channel
from navierstokes_tpu.model import NavierStokesSolver as JSolverModel
from navierstokes_tpu_torch import convert, run
from navierstokes_tpu_torch.config import (
    NewtonConfig,
    NSConfig,
    SolverConfig,
    resolve_supported,
)
from navierstokes_tpu_torch.io.dat import HEADER, read_petsc_vec, write_petsc_vec
from navierstokes_tpu_torch.mesh import channel_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver

from data_golden_trajectory import TRAJ

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
_PLANE = dict(preconditioner="two_level", spmv="plane")


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))


def test_flagship_slice_matches_jax():
    """Stokes + 3 steps at the flagship structure ('auto' -> two-level +
    Chebyshev 3, plane layout, exact Jacobian, operator residual) in f64
    with Krylov rtol 1e-12: states at rel 1e-9, Newton and GMRES counts
    equal or within 1 per solve."""
    kr = JSolver(rtol=1e-12, atol=1e-13, maxiter=4000,
                 preconditioner="auto", spmv="plane")
    jcfg = JNS(dt=0.01, t_final=0.03, reynolds=100.0, delta=0.1,
               dtype="float64", krylov=kr, stokes_krylov=kr)
    jmesh = j_channel(6, 3, 3, obstacle=True)
    js = JSolverModel(jmesh, jcfg)
    ts = NavierStokesSolver(convert.mesh_from_jax(jmesh),
                            convert.config_from_jax(jcfg), device=CPU)
    assert ts.cfg.krylov.preconditioner == js.cfg.krylov.preconditioner \
        == "two_level"
    assert ts.cfg.krylov.coarse_cheby == js.cfg.krylov.coarse_cheby == 3
    assert ts.cfg.krylov.coarse_agg == js.cfg.krylov.coarse_agg == 48

    uj = js.stokes_init()
    ut = ts.stokes_init()
    assert ts.stokes_result.converged
    assert _rel(ut.numpy(), uj) <= 1e-9

    # both packages step from the same (JAX) state each time
    du = np.zeros(uj.shape)
    u_old = np.array(uj)
    for _ in range(3):
        uj1, duj, sj = js.step(jnp.asarray(u_old), jnp.asarray(u_old),
                               jnp.asarray(du))
        ut1, _, st = ts.step(torch.as_tensor(u_old), torch.as_tensor(u_old),
                             torch.as_tensor(du))
        assert bool(sj.converged) and st.converged
        assert abs(st.iters - int(sj.iters)) <= 1
        assert abs(st.lin_iters - int(sj.lin_iters)) <= st.iters
        assert _rel(ut1.numpy(), uj1) <= 1e-9
        u_old, du = np.array(uj1), np.array(duj)


def test_golden_trajectory_flagship_mode():
    """The reference-derived 5-step trajectory (tests/data_golden_trajectory)
    in the flagship mode.  The Chebyshev smoother limits the match: the
    JAX package itself reaches 2.2e-8 here, so the bar is 1e-7."""
    golden = np.asarray(TRAJ)
    kr = SolverConfig(rtol=1e-13, atol=1e-14, maxiter=4000,
                      preconditioner="auto", spmv="plane")
    cfg = NSConfig(dt=1e-3, t_final=5e-3, reynolds=100.0, delta=0.1,
                   dtype="float64", krylov=kr, stokes_krylov=kr,
                   newton=NewtonConfig(rtol=1e-6, atol=1e-8, stol=1e-10,
                                       max_iter=30))
    s = NavierStokesSolver(channel_mesh(4, 2, 2), cfg, device=CPU)
    u = s.stokes_init()
    assert _rel(u.numpy(), golden[0]) < 1e-7
    u_old, du = u, torch.zeros_like(u)
    for step in range(1, 6):
        u, du, st = s.step(u, u_old, du)
        u_old = u
        assert st.converged
        err = _rel(u.numpy(), golden[step])
        assert err < 1e-7, f"step {step}: {err:.2e}"


def test_dat_writer_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.standard_normal(50), [0.0, -0.0, 1.0, -2.0,
                           2.5544, 1e-30, 123456789.0, np.inf, np.nan]])
    for arr in (vals, vals.astype(np.float32)):
        pj, pt = tmp_path / "j.dat", tmp_path / "t.dat"
        j_write(str(pj), jnp.asarray(arr))
        write_petsc_vec(str(pt), torch.as_tensor(arr))
        assert pt.read_bytes() == pj.read_bytes()
    back = read_petsc_vec(str(pt))
    assert back.shape == vals.shape
    np.testing.assert_allclose(back[:50], vals[:50], rtol=1e-5)


def test_cli_writes_dat_files(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "navierstokes_tpu_torch.run", "--nx", "4",
         "--ny", "2", "--nz", "2", "--steps", "2", "--save", "--save-dir",
         str(tmp_path / "res"), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
    )
    assert out.returncode == 0, out.stderr
    assert "=== Time step 2" in out.stdout
    files = sorted(os.listdir(tmp_path / "res"))
    assert files == ["solution_step0001.dat", "solution_step0002.dat"]
    for f in files:
        text = (tmp_path / "res" / f).read_text()
        assert text.startswith(HEADER)
        assert len(read_petsc_vec(str(tmp_path / "res" / f))) == 4 * 45


def test_solver_turns_tf32_off():
    """TF32 would round the coarse GEMV's f32 operands to 10 mantissa bits
    (the card's counterpart of the TPU bf16 trap): building a solver turns
    it off."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    cfg = NSConfig(krylov=SolverConfig(**_PLANE))
    NavierStokesSolver(channel_mesh(2, 1, 1), cfg, device=CPU)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_solver_rejects_schur():
    cfg = NSConfig(krylov=SolverConfig(preconditioner="schur", spmv="plane"))
    with pytest.raises(NotImplementedError, match="slice 6"):
        NavierStokesSolver(channel_mesh(2, 1, 1), cfg, device=CPU)


def test_auto_above_150k_rows_not_ported():
    """'auto' at nv = 40,000 (160k rows) resolves to the Schur tier."""
    cfg = NSConfig(krylov=SolverConfig(preconditioner="auto", spmv="plane"))
    with pytest.raises(NotImplementedError, match="slice 6"):
        resolve_supported(cfg, 40_000)
    assert resolve_supported(cfg, 37_500).krylov.coarse_cheby == 3


@pytest.mark.parametrize("cfg_kw,krylov_kw,slice_no", [
    ({}, dict(preconditioner="block_jacobi", spmv="plane"), 9),
    ({}, dict(preconditioner="ilu0", spmv="plane"), 11),
    ({}, dict(preconditioner="none", spmv="plane"), 11),
    ({}, dict(preconditioner="two_level", spmv="auto"), 9),
    ({}, dict(_PLANE, method="ca_gmres"), 12),
    ({}, dict(_PLANE, method="cg"), 11),
    ({}, dict(_PLANE, cgs2="pallas"), 14),
    ({}, dict(_PLANE, deflation_k=8), 13),
    ({}, dict(_PLANE, coarse_basis="linear"), 10),
    ({}, dict(_PLANE, coarse_smooth_omega=0.5), 10),
    ({}, dict(_PLANE, coarse_agg=4, coarse_dense_max=64), 10),
    ({}, dict(_PLANE, matvec_dtype="bfloat16"), 3),
    (dict(jacobian="reference"), _PLANE, 5),
    (dict(residual="elementwise"), _PLANE, 2),
])
def test_options_outside_the_slice_raise(cfg_kw, krylov_kw, slice_no):
    cfg = NSConfig(krylov=SolverConfig(**krylov_kw), **cfg_kw)
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        resolve_supported(cfg, 1000)


def test_stokes_krylov_only_sets_the_solve():
    """As in the JAX package, both operators are prepared from cfg.krylov;
    the default stokes_krylov (block_jacobi) is therefore accepted."""
    cfg = NSConfig(krylov=SolverConfig(**_PLANE))
    assert resolve_supported(cfg, 1000).stokes_krylov.preconditioner == \
        "block_jacobi"
    bad = dataclasses.replace(cfg, stokes_krylov=SolverConfig(method="cg"))
    with pytest.raises(NotImplementedError, match="slice 11"):
        resolve_supported(bad, 1000)


@pytest.mark.parametrize("argv,slice_no", [
    (["--msh", "mesh.msh"], 1),
    (["--nx", "2", "--vtu"], 7),
    (["--nx", "2", "--checkpoint", "ck.npz"], 7),
    (["--nx", "2", "--resume", "ck.npz"], 7),
    (["--nx", "2", "--devices", "2"], 15),
    (["--nx", "2", "--dtype", "float64"], 9),
])
def test_cli_flags_outside_the_slice_raise(argv, slice_no):
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        run.main(argv + ["--device", "cpu"])


def test_import_leaves_jax_out():
    code = ("import sys, navierstokes_tpu_torch, navierstokes_tpu_torch.run\n"
            "import navierstokes_tpu_torch.model, navierstokes_tpu_torch.convert\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'navierstokes_tpu.')) or m == 'navierstokes_tpu']\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
