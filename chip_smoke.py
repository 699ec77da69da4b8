"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require CUDA, print the card and its power limit, TF32 off;
  2. build: compile kernels K1 (`navierstokes_tpu_torch/csrc/plane_dia.cu`)
     and K2 (`csrc/dia.cu`) with nvcc for sm_90a, in parallel;
  3. K1 against its plain PyTorch version on the matrix-6 plane operator
     (4x4, 3x3 and 1x1 forms, float32 and float64);
  4. K2 against its plain version on the matrix-6 scalar-DIA operators: A
     (81 diagonals), S = D^{-1} A (123) and D^{-1} (7), float32 and
     float64.  Phases 3 and 4 time each with CUDA events, with and without
     an L2 flush, beside the plain version, cuSPARSE's CSR SpMV on the same
     matrix (torch.sparse, the yardstick) and the HBM bound;
  5. plane path: `run.main` at matrix 6 in float32 (Stokes + 5 steps, the
     'tlp' flagship), K1 launch counter reset before and read after, with
     the physics checks of the repo (BC values exact, finite state,
     downstream flow, .dat header);
  6. scalar two-level path: `run.main --spmv pallas` at matrix 6 in float32
     (the 'tl' prep), K2 counted; GMRES per step within 0.8x-1.25x of the
     plane path's, the same physics checks;
  7. the float64 CLI default (block-Jacobi + Neumann 2, the 'bj' prep) at
     matrix 6, Stokes + 2 steps, K2 counted, the same physics checks;
  8. small-input reference: the golden 5-step trajectory of
     `tests/data_golden_trajectory.py` (reference-derived C) in float64, in
     flagship mode and on the block-Jacobi path, each run twice: the
     second run must repeat the first bit for bit;
then the kernel summary line and, last, the device line.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

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
from navierstokes_tpu_torch.ops import dia as dia_ops
from navierstokes_tpu_torch.ops import plane_dia as pd
from navierstokes_tpu_torch.ops.block import block4_inverse
from navierstokes_tpu_torch.solvers.coarse import build_aggregates
from navierstokes_tpu_torch.sparse.dia import (
    block_diag_to_dia,
    diag_blocks_from_dia,
    scale_rows_dia,
    zero_rows_dia,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
NNZ_M6 = 6_675_376          # scalar nonzeros of matrix 6 (2*nnz/t GF/s)
JAX_LIN_PER_STEP = 37       # JAX package on TPU v5e (BENCH_r05), comparison only
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}  # H100 SXM, no TC
# The golden bar on the block-Jacobi path: min(10x the JAX package's own
# error, 1e-7), the JAX error (9.614e-12) measured by
# tests/test_torch_model.py::test_golden_trajectory_block_jacobi.
GOLDEN_BJ_BAR = 9.614e-11
KERNELS = {
    "plane_spmv": ("plane_dia", "navierstokes_tpu_torch/csrc/plane_dia.cu",
                   "navierstokes_tpu/ops/plane_dia.py:113"),
    "dia_spmv": ("dia", "navierstokes_tpu_torch/csrc/dia.cu",
                 "navierstokes_tpu/ops/pallas_dia.py:35"),
}


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


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """(least time in ms, what bounds it): bytes over the HBM rate against
    operations over the card's peak rate for the dtype."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def csr_from_coo(rows, cols, vals, n):
    """A CUDA CSR matrix from COO triplets (explicit zeros dropped)."""
    keep = vals != 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(
            torch.stack([rows[keep], cols[keep]]), vals[keep], (n, n))
        return coo.coalesce().to_sparse_csr()


def dia_csr(offsets, data):
    """The scalar-DIA matrix (offsets, data) as CSR, entries in range."""
    k, n = data.shape
    i = torch.arange(n, device=data.device)
    rows, cols, vals = [], [], []
    for kk, d in enumerate(offsets):
        lo, hi = max(0, -d), min(n, n - d)
        rows.append(i[lo:hi])
        cols.append(i[lo:hi] + d)
        vals.append(data[kk, lo:hi])
    return csr_from_coo(torch.cat(rows), torch.cat(cols), torch.cat(vals), n)


def plane_csr(noffs, planes, nb, nbp):
    """The 4x4 plane operator as CSR in plane ordering (row a*nbp + i,
    column b*nbp + i + D), live rows and in-range columns only."""
    i = torch.arange(nb, device=planes.device)
    rows, cols, vals = [], [], []
    for a in range(4):
        for j, (b, d) in enumerate(pd.plane_terms(noffs)):
            ok = (i + d >= 0) & (i + d < nbp)
            rows.append(a * nbp + i[ok])
            cols.append(b * nbp + i[ok] + d)
            vals.append(planes[a, j, :nb][ok])
    return csr_from_coo(torch.cat(rows), torch.cat(cols), torch.cat(vals),
                        4 * nbp)


def time_all(kern, plain, library, flush) -> dict:
    """Flushed and L2-warm CUDA-event times of the kernel, its plain
    version and the library call (None where there is none)."""
    t = {"lib": None, "lib_flush": None}
    for name, fn in (("k", kern), ("p", plain), ("lib", library)):
        if fn is not None:
            t[name] = event_ms(fn, 25)
            t[name + "_flush"] = event_ms(fn, 25, flush=flush)
    return t


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
    libs = [lib for lib, _, _ in KERNELS.values()]
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as ex:
        built = list(ex.map(cuda_lib.load, libs))
    print(f"K1 and K2 built in {time.perf_counter() - t0:.3f} s (parallel)")
    for lib, (_, info) in zip(libs, built):
        print(f"{lib}: {info.seconds:.3f} s (cached={info.cached}) -> "
              f"{os.path.relpath(info.path, ROOT)}")
        print(info.log.strip())


def m6_operator(dev):
    """The matrix-6 exact-Jacobian operator (BC rows applied), float64."""
    mesh = scaling_series_mesh(6)
    disc = build_discretization(mesh, torch.float64, dev)
    pat = disc.dia_pattern
    data = assemble_dia_values(disc.vol, disc.grad, disc.h, 1e-3, 300.0, 0.05,
                               disc.dia_elem_map, terms=LINEAR_TERMS,
                               K=pat.K, ndof=disc.ndof)
    data = zero_rows_dia(pat.offsets, data, disc.bc.is_bc)
    if pat.nnz != NNZ_M6:
        raise AssertionError(f"matrix-6 nnz {pat.nnz} != {NNZ_M6}")
    return mesh, pat, data


def k1_phase(dev, mesh, pat, data64, flush):
    phase("K1 against its plain version (matrix-6 shapes)")
    noffs = pd.node_offsets_from_scalar(pat.offsets)
    nb = mesh.nv
    nbp = pd.plane_nbp(nb, build_aggregates(nb, 48).nb_pad)
    p4_64 = pd.extract_planes(pat.offsets, data64, nb, node_offsets=noffs,
                              nbp=nbp)
    print(f"matrix 6: nb={nb} nbp={nbp} K={pat.K} N_D={len(noffs)} "
          f"nnz={pat.nnz} offsets {noffs[0]}..{noffs[-1]}")
    n_d = len(noffs)
    sel3 = [iD * 4 + b for iD in range(n_d) for b in range(3)]
    sel1 = [iD * 4 + 3 for iD in range(n_d)]
    forms = {
        "4x4": (p4_64, 4),
        "3x3": (p4_64[:3][:, sel3].contiguous(), 3),
        "1x1": (p4_64[3:4][:, sel1].contiguous(), 1),
    }
    rng = np.random.default_rng(2024)
    bars = {torch.float32: 1e-5, torch.float64: 1e-12}
    summary = {}
    for dtype, bar in bars.items():
        for form, (planes64, n_in) in forms.items():
            data = planes64.to(dtype).contiguous()
            n_out = data.shape[0]
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

            library = None
            if form == "4x4":
                csr = plane_csr(noffs, data, nb, nbp)
                y_lib = csr @ x
                lib_rel = float(torch.linalg.norm(y_lib - ref)
                                / torch.linalg.norm(ref))
                if lib_rel > bar:
                    raise AssertionError(f"cuSPARSE CSR disagrees: {lib_rel}")

                def library():
                    csr @ x
            t = time_all(kern, plain, library, flush)
            nbytes = data.element_size() * (data.numel() + (n_in + n_out)
                                            * nbp)
            t["bound"], t["bound_by"] = bound_ms(
                nbytes, 2 * NNZ_M6 * n_out * n_in / 16, dtype)
            nnz = NNZ_M6 * n_out * n_in // 16
            gfs = 2 * nnz / (t["k_flush"] * 1e-3) / 1e9
            lib_txt = (f" | cuSPARSE CSR {t['lib_flush']:.4f} ms flushed, "
                       f"{t['lib']:.4f} ms L2-warm" if library else "")
            print(f"K1 {form} {str(dtype)[6:]}: rel {rel:.3e} max_abs "
                  f"{abs_err:.3e} | kernel {t['k_flush']:.4f} ms flushed "
                  f"({gfs:.1f} GF/s), {t['k']:.4f} ms L2-warm | plain "
                  f"{t['p_flush']:.4f} ms flushed, {t['p']:.4f} ms L2-warm"
                  f"{lib_txt} | bound {t['bound']:.4f} ms ({t['bound_by']})",
                  flush=True)
            summary[(form, dtype)] = (abs_err, t)
    return summary


def k2_phase(dev, mesh, pat, data64, flush):
    phase("K2 against its plain version (matrix-6 shapes)")
    nb, n = mesh.nv, 4 * mesh.nv
    inv = block4_inverse(diag_blocks_from_dia(pat.offsets, data64, nb),
                         pivot_eps=1e-300, shift=1e-8)
    s_off, s_data = scale_rows_dia(pat, data64, inv)
    dinv = block_diag_to_dia(inv)
    forms = {"A": (pat.offsets, data64), "S": (s_off, s_data),
             "Dinv": (dinv.offsets, dinv.data)}
    print(f"matrix 6: n={n} K(A)={pat.K} K(S)={len(s_off)} K(Dinv)=7 "
          f"halo(A)={max(map(abs, pat.offsets))} "
          f"halo(S)={max(map(abs, s_off))}")
    rng = np.random.default_rng(2025)
    bars = {torch.float32: 1e-5, torch.float64: 1e-12}
    summary = {}
    for dtype, bar in bars.items():
        for form, (offsets, d64) in forms.items():
            data = d64.to(dtype).contiguous()
            x = torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                device=dev)
            y = dia_ops.spmv_dia(offsets, data, x)
            torch.cuda.synchronize()
            ref = dia_ops.spmv_dia_plain(offsets, data, x)
            rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
            abs_err = float((y - ref).abs().max())
            if not (y.dtype == dtype and rel <= bar):
                raise AssertionError(f"K2 {form} {dtype}: rel {rel:.3e} "
                                     f"(bar {bar})")
            csr = dia_csr(offsets, data)
            lib_rel = float(torch.linalg.norm(csr @ x - ref)
                            / torch.linalg.norm(ref))
            if lib_rel > bar:
                raise AssertionError(f"cuSPARSE CSR disagrees: {lib_rel}")

            def kern():
                dia_ops.spmv_dia(offsets, data, x)

            def plain():
                dia_ops.spmv_dia_plain(offsets, data, x)

            def library():
                csr @ x

            t = time_all(kern, plain, library, flush)
            in_range = sum(n - abs(d) for d in offsets)
            t["bound"], t["bound_by"] = bound_ms(
                data.element_size() * (data.numel() + 2 * n), 2 * in_range,
                dtype)
            print(f"K2 {form} {str(dtype)[6:]} (K={len(offsets)}): rel "
                  f"{rel:.3e} max_abs {abs_err:.3e} | kernel "
                  f"{t['k_flush']:.4f} ms flushed, {t['k']:.4f} ms L2-warm | "
                  f"plain {t['p_flush']:.4f} / {t['p']:.4f} ms | cuSPARSE "
                  f"CSR (nnz {csr.values().numel()}) {t['lib_flush']:.4f} / "
                  f"{t['lib']:.4f} ms | bound {t['bound']:.4f} ms "
                  f"({t['bound_by']})", flush=True)
            summary[(form, dtype)] = (abs_err, t)
    return summary


def reset_counters():
    pd.reset_counters()
    dia_ops.reset_counters()


def counters() -> dict:
    return {"K1": pd.kernel_launches, "K1 plain": pd.plain_calls,
            "K2": dia_ops.kernel_launches, "K2 plain": dia_ops.plain_calls}


def drive(label: str, argv: list, n_steps: int, max_newton=3,
          stokes_must_converge=True):
    """run.main with the kernel counters reset just before and read just
    after, then the step, Stokes and physics checks; returns (RunOutput,
    counts)."""
    phase(label)
    with tempfile.TemporaryDirectory() as save_dir:
        reset_counters()
        out = run.main(argv + ["--steps", str(n_steps), "--save",
                               "--save-dir", save_dir, "--device", "cuda"])
        counts = counters()
        with open(os.path.join(save_dir,
                               f"solution_step{n_steps:04d}.dat")) as f:
            head = f.read(len(HEADER))
        n_dat = len([n for n in os.listdir(save_dir) if n.endswith(".dat")])
    solver = out.solver
    for step, st, sec in solver.history:
        print(f"step {step}: newton={st.iters} gmres={st.lin_iters} "
              f"converged={st.converged} {sec * 1e3:.1f} ms")
    hist = solver.history
    step_ms = 1e3 * sum(sec for _, _, sec in hist) / len(hist)
    print(f"Stokes: gmres={solver.stokes_result.iters} "
          f"converged={solver.stokes_result.converged}")
    print(f"setup {out.setup_s:.3f} s, Stokes {out.stokes_s:.3f} s, "
          f"operator prep {out.prep_s:.3f} s, mean step {step_ms:.2f} ms")
    print(f"kernel counts on this path: {counts}")
    if len(hist) != n_steps or n_dat != n_steps or head != HEADER:
        raise AssertionError(f"{len(hist)} steps, {n_dat} .dat files, "
                             f"header {head!r}")
    if stokes_must_converge and not solver.stokes_result.converged:
        raise AssertionError("Stokes solve did not converge")
    for step, st, _ in hist:
        if not st.converged or (max_newton and st.iters > max_newton):
            raise AssertionError(f"step {step}: newton={st.iters} "
                                 f"converged={st.converged}")
    check_physics(out)
    # one more step from the final state, counted alone: launches per step
    reset_counters()
    _, _, st = solver.step(out.u, out.u, torch.zeros_like(out.u))
    print(f"one more step (newton={st.iters} gmres={st.lin_iters}): kernel "
          f"counts {counters()}")
    return out, counts


def check_physics(out) -> None:
    mesh = out.solver.disc.mesh
    u = out.u.detach().cpu().numpy()
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
    print(f"physics: inlet exact, obstacle 0, interior mean u_x "
          f"{ux_mean:.4f}, .dat header ok")


def mean_lin(out) -> float:
    lin = [st.lin_iters for _, st, _ in out.solver.history]
    return sum(lin) / len(lin)


def plane_path_phase():
    out, counts = drive("plane path: run.main --matrix-id 6, float32, "
                        "Stokes + 5 steps ('tlp')",
                        ["--matrix-id", "6", "--re", "300", "--dt", "1e-3",
                         "--delta", "0.05", "--dtype", "float32"], 5)
    lin = mean_lin(out)
    print(f"mean GMRES iterations per step {lin:.1f} (JAX package on TPU "
          f"v5e: {JAX_LIN_PER_STEP}, BENCH_r05, for comparison only)")
    if out.solver.prep_kind != "tlp":
        raise AssertionError(f"prep {out.solver.prep_kind}")
    if not 0.5 * JAX_LIN_PER_STEP <= lin <= 2 * JAX_LIN_PER_STEP:
        raise AssertionError(f"mean GMRES/step {lin} outside 0.5x-2x of "
                             f"{JAX_LIN_PER_STEP}")
    if counts["K1"] <= 0 or counts["K1 plain"] or counts["K2 plain"]:
        raise AssertionError(f"kernel counts {counts}")
    return counts["K1"], lin


def scalar_path_phase(plane_lin: float):
    out, counts = drive("scalar two-level path: run.main --matrix-id 6 "
                        "--spmv pallas, float32, Stokes + 5 steps ('tl')",
                        ["--matrix-id", "6", "--spmv", "pallas", "--dtype",
                         "float32"], 5)
    kr = out.solver.cfg.krylov
    lin = mean_lin(out)
    print(f"mean GMRES iterations per step {lin:.1f} (plane path "
          f"{plane_lin:.1f}); preconditioner {kr.preconditioner}, "
          f"coarse_cheby {kr.coarse_cheby}, coarse_agg {kr.coarse_agg}")
    if out.solver.prep_kind != "tl" or kr.coarse_cheby != 3 \
            or kr.coarse_agg != 48:
        raise AssertionError(f"prep {out.solver.prep_kind}, {kr}")
    if not 0.8 * plane_lin <= lin <= 1.25 * plane_lin:
        raise AssertionError(f"mean GMRES/step {lin} outside 0.8x-1.25x of "
                             f"the plane path's {plane_lin}")
    if counts["K2"] <= 0 or counts["K1"] or counts["K1 plain"] \
            or counts["K2 plain"]:
        raise AssertionError(f"kernel counts {counts}")
    return counts["K2"]


def f64_default_phase():
    # The JAX package's float64 Stokes config (rtol 1e-12, maxiter 2000)
    # stops at maxiter under block-Jacobi at this size, as in the JAX
    # package; the run goes on from that state, and the steps must
    # converge.  Newton takes 4 iterations per step in f64 (|du| < 1e-8).
    out, counts = drive("float64 CLI default: run.main --matrix-id 6 "
                        "--dtype float64, Stokes + 2 steps ('bj')",
                        ["--matrix-id", "6", "--dtype", "float64"], 2,
                        max_newton=None, stokes_must_converge=False)
    kr = out.solver.cfg.krylov
    if out.solver.prep_kind != "bj" or kr.neumann_order != 2 \
            or out.u.dtype != torch.float64:
        raise AssertionError(f"prep {out.solver.prep_kind}, {kr}")
    if counts["K2"] <= 0 or counts["K1"] or counts["K2 plain"]:
        raise AssertionError(f"kernel counts {counts}")
    return counts["K2"]


def golden_phase(dev):
    phase("small-input reference: golden trajectory, float64 on the card")
    spec = importlib.util.spec_from_file_location(
        "data_golden_trajectory",
        os.path.join(ROOT, "tests", "data_golden_trajectory.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    golden = np.asarray(mod.TRAJ)
    newton = NewtonConfig(rtol=1e-6, atol=1e-8, stol=1e-10)

    def trajectory(kw):
        kr = SolverConfig(rtol=1e-13, atol=1e-14, maxiter=4000, **kw)
        cfg = NSConfig(dt=1e-3, t_final=5e-3, reynolds=100.0, delta=0.1,
                       dtype="float64", krylov=kr, stokes_krylov=kr,
                       newton=newton)
        solver = NavierStokesSolver(channel_mesh(4, 2, 2), cfg, device=dev)
        states = [solver.stokes_init()]
        du = torch.zeros_like(states[0])
        for _ in range(5):
            u, du, _ = solver.step(states[-1], states[-1], du)
            states.append(u)
        return solver.prep_kind, torch.stack(states).cpu().numpy()

    for mode, kw, bar in (
            ("flagship mode", dict(preconditioner="auto", spmv="plane"),
             1e-7),
            ("block-Jacobi path", {}, GOLDEN_BJ_BAR)):
        kind, states = trajectory(kw)
        errs = [np.linalg.norm(u - g) / np.linalg.norm(g)
                for u, g in zip(states, golden)]
        print(f"golden rel errors, {mode} ({kind}; Stokes, steps 1-5): "
              + " ".join(f"{e:.3e}" for e in errs) + f" (bar {bar:.3e})")
        if max(errs) > bar:
            raise AssertionError(f"golden trajectory ({mode}) off by "
                                 f"{max(errs):.3e}")
        # assembly adds in a fixed order: a second run repeats bit for bit
        if not np.array_equal(trajectory(kw)[1], states):
            raise AssertionError(f"golden trajectory ({mode}) differs "
                                 "between two runs")
    print("golden trajectories repeat bit for bit in a second run")


def kernel_entry(name: str, launches: int, abs_err: float, t: dict) -> dict:
    _, source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": abs_err, "ms": t["k_flush"],
            "plain_ms": t["p_flush"], "bound_ms": t["bound"],
            "bound_by": t["bound_by"],
            "library_ms": t["lib_flush"]}


def main() -> int:
    kind = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    mesh, pat, data64 = m6_operator(dev)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    k1 = k1_phase(dev, mesh, pat, data64, flush)
    k2 = k2_phase(dev, mesh, pat, data64, flush)
    del flush, data64
    k1_launches, plane_lin = plane_path_phase()
    k2_launches = scalar_path_phase(plane_lin)
    f64_launches = f64_default_phase()
    golden_phase(dev)

    print(f"K2 launches: scalar two-level path {k2_launches}, float64 "
          f"default {f64_launches}")
    print(json.dumps({"kernels": [
        kernel_entry("plane_spmv", k1_launches, *k1[("4x4", torch.float32)]),
        kernel_entry("dia_spmv", k2_launches, *k2[("A", torch.float32)]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
