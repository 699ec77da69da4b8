"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require CUDA, print the card and its power limit, TF32 off;
  2. build: compile kernel K1 (`navierstokes_tpu_torch/csrc/plane_dia.cu`)
     with nvcc for sm_90a;
  3. K1 against its plain PyTorch version on the matrix-6 plane operator
     (4x4, 3x3 and 1x1 forms, float32 and float64), with CUDA-event times
     with and without an L2 flush;
  4. main path: `navierstokes_tpu_torch.run.main` at matrix 6 in float32
     (Stokes init + 5 backward-Euler steps), with the K1 launch counter
     reset before and read after, and the physics checks of the repo
     (BC values exact, finite state, downstream flow, .dat header);
  5. small-input reference: the golden 5-step trajectory of
     `tests/data_golden_trajectory.py` (reference-derived C) in float64;
then the kernel summary line and, last, the device line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from navierstokes_tpu_torch import run
from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu_torch.fem.assembly import (
    LINEAR_TERMS,
    assemble_dia_values,
    build_discretization,
)
from navierstokes_tpu_torch.io.dat import HEADER
from navierstokes_tpu_torch.mesh.box import channel_mesh, scaling_series_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.ops import cuda_lib
from navierstokes_tpu_torch.ops import plane_dia as pd
from navierstokes_tpu_torch.solvers.coarse import build_aggregates
from navierstokes_tpu_torch.sparse.dia import zero_rows_dia

ROOT = os.path.dirname(os.path.abspath(__file__))
NNZ_M6 = 6_675_376          # scalar nonzeros of matrix 6 (2*nnz/t GF/s)
JAX_LIN_PER_STEP = 37       # JAX package on TPU v5e (BENCH_r05), comparison only
K1_SOURCE = "navierstokes_tpu_torch/csrc/plane_dia.cu"
K1_REPLACES = "navierstokes_tpu/ops/plane_dia.py:113"


def phase(name: str) -> None:
    print(f"--- {name}", flush=True)


def event_ms(fn, reps: int, flush=None, sleep_cycles: int = 20_000_000):
    """Median device time of fn() in ms over `reps` runs, from CUDA events.

    Before each run the stream sleeps, so the host enqueues the events and
    fn's launches while the device waits: the events bracket device work
    only, not Python launch overhead.  With `flush`, a buffer larger than
    the 50 MB L2 is rewritten first, so fn reads from device memory."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    phase("device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    print(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return kind


def build_phase():
    phase("build")
    t0 = time.perf_counter()
    _, info = cuda_lib.load("plane_dia")
    print(f"K1 built in {time.perf_counter() - t0:.3f} s "
          f"(cached={info.cached}) -> {os.path.relpath(info.path, ROOT)}")
    print(info.log.strip())


def m6_planes(dev):
    """The matrix-6 exact-Jacobian operator in plane layout, float64."""
    mesh = scaling_series_mesh(6)
    disc = build_discretization(mesh, torch.float64, dev)
    pat = disc.dia_pattern
    data = assemble_dia_values(disc.vol, disc.grad, disc.h, 1e-3, 300.0, 0.05,
                               disc.dia_elem_map, terms=LINEAR_TERMS,
                               K=pat.K, ndof=disc.ndof)
    data = zero_rows_dia(pat.offsets, data, disc.bc.is_bc)
    noffs = pd.node_offsets_from_scalar(pat.offsets)
    nb = mesh.nv
    nbp = pd.plane_nbp(nb, build_aggregates(nb, 48).nb_pad)
    p4 = pd.extract_planes(pat.offsets, data, nb, node_offsets=noffs, nbp=nbp)
    print(f"matrix 6: nb={nb} nbp={nbp} K={pat.K} N_D={len(noffs)} "
          f"nnz={pat.nnz} offsets {noffs[0]}..{noffs[-1]}")
    if pat.nnz != NNZ_M6:
        raise AssertionError(f"matrix-6 nnz {pat.nnz} != {NNZ_M6}")
    return p4, noffs, nb, nbp


def kernel_phase(dev):
    phase("K1 against its plain version (matrix-6 shapes)")
    p4_64, noffs, nb, nbp = m6_planes(dev)
    n_d = len(noffs)
    sel3 = [iD * 4 + b for iD in range(n_d) for b in range(3)]
    sel1 = [iD * 4 + 3 for iD in range(n_d)]
    forms = {
        "4x4": (p4_64, 4),
        "3x3": (p4_64[:3][:, sel3].contiguous(), 3),
        "1x1": (p4_64[3:4][:, sel1].contiguous(), 1),
    }
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    rng = np.random.default_rng(2024)
    bars = {torch.float32: 1e-5, torch.float64: 1e-12}
    summary = {}
    for dtype, bar in bars.items():
        for form, (planes64, n_in) in forms.items():
            data = planes64.to(dtype).contiguous()
            x = torch.as_tensor(rng.standard_normal(n_in * nbp), dtype=dtype,
                                device=dev)
            x.reshape(n_in, nbp)[:, nb:] = 0
            y = pd.spmv_planes(noffs, data, x, n_in=n_in, nb=nb)
            torch.cuda.synchronize()
            ref = pd.spmv_planes_plain(noffs, data, x, n_in=n_in, nb=nb)
            rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
            abs_err = float((y - ref).abs().max())
            pad = float(y.reshape(-1, nbp)[:, nb:].abs().max())
            if not (rel <= bar and pad == 0.0):
                raise AssertionError(f"K1 {form} {dtype}: rel {rel:.3e} "
                                     f"(bar {bar}), padding max {pad}")

            def kern():
                pd.spmv_planes(noffs, data, x, n_in=n_in, nb=nb)

            def plain():
                pd.spmv_planes_plain(noffs, data, x, n_in=n_in, nb=nb)

            t = {}
            for name, fn in (("k", kern), ("p", plain)):
                t[name] = event_ms(fn, 25)
                t[name + "_flush"] = event_ms(fn, 25, flush=flush)
            nnz = NNZ_M6 * data.shape[0] * n_in // 16
            gfs = 2 * nnz / (t["k_flush"] * 1e-3) / 1e9
            gfs_l2 = 2 * nnz / (t["k"] * 1e-3) / 1e9
            print(f"K1 {form} {str(dtype)[6:]}: rel {rel:.3e} max_abs "
                  f"{abs_err:.3e} | kernel {t['k_flush']:.4f} ms flushed "
                  f"({gfs:.1f} GF/s), {t['k']:.4f} ms L2-warm "
                  f"({gfs_l2:.1f} GF/s) | plain {t['p_flush']:.4f} ms "
                  f"flushed, {t['p']:.4f} ms L2-warm", flush=True)
            summary[(form, dtype)] = (abs_err, t)
    return summary


def main_path_phase(dev):
    phase("main path: run.main --matrix-id 6, float32, Stokes + 5 steps")
    with tempfile.TemporaryDirectory() as save_dir:
        pd.reset_counters()
        out = run.main(["--matrix-id", "6", "--re", "300", "--dt", "1e-3",
                        "--delta", "0.05", "--steps", "5", "--save",
                        "--save-dir", save_dir, "--device", "cuda"])
        launches, plain = pd.kernel_launches, pd.plain_calls
        with open(os.path.join(save_dir, "solution_step0005.dat")) as f:
            head = f.read(len(HEADER))
        n_dat = len([n for n in os.listdir(save_dir) if n.endswith(".dat")])

    solver = out.solver
    mesh = solver.disc.mesh
    u = out.u.detach().cpu().numpy()
    hist = solver.history
    for step, st, sec in hist:
        print(f"step {step}: newton={st.iters} gmres={st.lin_iters} "
              f"converged={st.converged} {sec * 1e3:.1f} ms")
    lin = [st.lin_iters for _, st, _ in hist]
    mean_lin = sum(lin) / len(lin)
    step_ms = 1e3 * sum(sec for _, _, sec in hist) / len(hist)
    print(f"Stokes: gmres={solver.stokes_result.iters} "
          f"converged={solver.stokes_result.converged}")
    print(f"mean GMRES iterations per step {mean_lin:.1f} (JAX package on "
          f"TPU v5e: {JAX_LIN_PER_STEP}, BENCH_r05, for comparison only)")
    print(f"setup {out.setup_s:.3f} s, Stokes {out.stokes_s:.3f} s, "
          f"operator prep {out.prep_s:.3f} s, mean step {step_ms:.2f} ms")
    print(f"K1 launches on the main path: {launches}, plain calls: {plain}")

    if len(hist) != 5 or n_dat != 5:
        raise AssertionError(f"{len(hist)} steps, {n_dat} .dat files")
    for step, st, _ in hist:
        if not st.converged or st.iters > 3:
            raise AssertionError(f"step {step}: newton={st.iters} "
                                 f"converged={st.converged}")
    if not 0.5 * JAX_LIN_PER_STEP <= mean_lin <= 2 * JAX_LIN_PER_STEP:
        raise AssertionError(f"mean GMRES/step {mean_lin} outside 0.5x-2x "
                             f"of {JAX_LIN_PER_STEP}")
    if u.shape != (4 * mesh.nv,) or not np.all(np.isfinite(u)):
        raise AssertionError("state is not finite or has the wrong shape")
    u4 = u.reshape(-1, 4)
    tags = mesh.node_tags
    y, z = mesh.coords[:, 1], mesh.coords[:, 2]
    inlet = tags == 2
    want = ((1.0 - y[inlet] ** 2) * (1.0 - z[inlet] ** 2)).astype(u.dtype)
    if not np.array_equal(u4[inlet, 0], want):
        raise AssertionError("inlet u_x != (1-y^2)(1-z^2)")
    if not np.all(u4[tags == 1, :3] == 0):
        raise AssertionError("obstacle velocity is not exactly 0")
    ux_mean = float(u4[tags == -1, 0].mean())
    if not ux_mean > 0:
        raise AssertionError(f"interior mean u_x {ux_mean} <= 0")
    if head != HEADER:
        raise AssertionError(f".dat header {head!r}")
    if launches <= 0 or plain != 0:
        raise AssertionError(f"K1 launches {launches}, plain calls {plain}")
    print(f"physics: inlet exact, obstacle 0, interior mean u_x "
          f"{ux_mean:.4f}, .dat header ok")
    return launches


def golden_phase(dev):
    phase("small-input reference: golden trajectory, float64 on the card")
    spec = importlib.util.spec_from_file_location(
        "data_golden_trajectory",
        os.path.join(ROOT, "tests", "data_golden_trajectory.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    golden = np.asarray(mod.TRAJ)
    kr = SolverConfig(rtol=1e-13, atol=1e-14, maxiter=4000,
                      preconditioner="auto", spmv="plane")
    cfg = NSConfig(dt=1e-3, t_final=5e-3, reynolds=100.0, delta=0.1,
                   dtype="float64", krylov=kr, stokes_krylov=kr,
                   newton=NewtonConfig(rtol=1e-6, atol=1e-8, stol=1e-10))
    solver = NavierStokesSolver(channel_mesh(4, 2, 2), cfg, device=dev)
    u = solver.stokes_init()
    errs = [np.linalg.norm(u.cpu().numpy() - golden[0])
            / np.linalg.norm(golden[0])]
    u_old, du = u, torch.zeros_like(u)
    for step in range(1, 6):
        u, du, _ = solver.step(u, u_old, du)
        u_old = u
        errs.append(np.linalg.norm(u.cpu().numpy() - golden[step])
                    / np.linalg.norm(golden[step]))
    print("golden rel errors (Stokes, steps 1-5): "
          + " ".join(f"{e:.2e}" for e in errs))
    if max(errs) > 1e-7:
        raise AssertionError(f"golden trajectory off by {max(errs):.2e}")


def main() -> int:
    kind = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    summary = kernel_phase(dev)
    launches = main_path_phase(dev)
    golden_phase(dev)

    abs_err, t = summary[("4x4", torch.float32)]
    print(json.dumps({"kernels": [{
        "name": "plane_spmv", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": abs_err, "ms": t["k_flush"], "plain_ms": t["p_flush"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
