"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require CUDA, print the card and its power limit, TF32 off;
  2. build: compile kernels K1 (`navierstokes_tpu_torch/csrc/plane_dia.cu`),
     K2 (`csrc/dia.cu`), K3 (`csrc/cgs2.cu`) and K4 (`csrc/mpk.cu`) with
     nvcc for sm_90a, in parallel;
  3. K1, both routes (tiled and row-per-thread), against its plain PyTorch
     version on the matrix-6 plane operator (4x4, 3x3 and 1x1 forms,
     float32 and float64), and on random data that is nonzero where i + D
     leaves the matrix.  The routes are timed in turns (rows, tiled,
     tiled, rows) with CUDA events, with and without an L2 flush, beside
     the plain version, cuSPARSE's CSR SpMV on the same matrix
     (torch.sparse, the yardstick, for every form) and the HBM bound, with
     the launch floor (each route on one tile) and what a launch of each
     route costs the host; then both routes at a quarter, 4x and 8x of
     matrix 6's rows, where a block walks several tiles;
  4. K2 against its plain version on the matrix-6 scalar-DIA operators:
     A (81 diagonals), S = D^{-1} A (123) and D^{-1} (7), float32 and
     float64, and on random data likewise, timed like K1.  Phases 3 and 4
     require a second call to repeat the first bit for bit;
  4b. K2's bf16 form (matvec_dtype): A and S rounded to bf16, x in float32
     (rel 1e-6) and float64 (rel 1e-13) against its plain version, also on
     random data nonzero outside the matrix, a second call equal bit for
     bit; timed in turns with the f32 K2 on the same operator, flushed and
     L2-warm, beside cuSPARSE f32 and the bound (no PyTorch call computes
     bf16 data times an f32 x);
  5. K1 on the Schur tier's forms: the real S_hat (1x1 on its 65 node
     offsets, the sumset of the 15) of matrices 6 and 8, both routes,
     float32 and float64, equal bit for bit between routes and within the
     bar of the plain version; and matrix 8's 4x4, 3x3 F, 1x3 A_pu and
     3x1 A_up by the route the wrapper chooses; each timed flushed and
     L2-warm beside cuSPARSE and the bound, with its tile plan (tile, node
     offsets per stage G, x window clusters, stages, shared bytes); then
     S_hat, 1x3 and 3x3 on random data nonzero outside the matrix, both
     routes equal bit for bit;
  6. K3 against its plain version at the matrix-6 Krylov shapes (V of
     31 x 117,760 in float32, the plane layout, and 31 x 117,500 in
     float64) and at matrix 8's n = 511,024, where V[:k+1] does not fit in
     shared memory; k = 0, 15, 29; plain and compensated sums; rows above
     k poisoned with NaN, a second call equal bit for bit; timed beside
     the four cuBLAS GEMVs of the cgs2='xla' path and the HBM bound (one
     read of V[:k+1], w in, w2 and h out), with its plan (grid, resident
     rows, passes over V), the floor of a cooperative launch with 0-2
     grid barriers and what a call costs the host;
  7. K4 (z = A^p x, p = 2, 3, 4, float32 and float64) on the matrix-6
     operator A, equal bit for bit to p chained K2 launches and within
     the bar of its plain version, timed beside those, p chained cuSPARSE
     CSR SpMVs and the HBM bound, with its plan (resident diagonals,
     passes over A) and the cooperative floor with p - 1 barriers; then
     offsets of +-6000 on random data, a halo too wide for a design of
     overlapping row tiles, and of +-20,000, too wide for K4's source
     window in shared memory;
  8. plane path: `run.main` at matrix 6 in float32 (Stokes + 5 steps, the
     'tlp' flagship), the kernel launch counters reset before and read
     after, with the physics checks of the repo (BC values exact, finite
     state, downstream flow, .dat header);
  8b. the same with the caller's TF32 flags on: the solver turns TF32 off
     for its own work only, so Stokes and every step take phase 8's
     Newton and GMRES counts and end in its state bit for bit, and the
     flags read True after;
  9. the same with `--cgs2 pallas` (K3 in every GMRES iteration): GMRES per
     step within 0.8x-1.25x of phase 8's, K3 and K1 counted;
 10. scalar two-level path: `run.main --spmv pallas` at matrix 6 in float32
     (the 'tl' prep), K2 counted; GMRES per step within 0.8x-1.25x of the
     plane path's, the same physics checks;
 11. `--spmv pallas --cgs2 pallas_comp` ('tl', K3 with compensated sums),
     Stokes + 2 steps, K3 and K2 counted;
 12. the float64 CLI default (block-Jacobi + Neumann 2, the 'bj' prep) at
     matrix 6, Stokes + 2 steps, K2 counted, the same physics checks;
 12b. matvec_dtype='bfloat16' at matrix 6 in float32 on 'tl' and 'bj',
     through NavierStokesSolver beside full precision: every step
     converges, the bf16 K2 form counted and no plain call, on 'tl' the
     state of 3 steps from one Stokes state within rel 5e-2 of full
     precision (on 'bj' printed: it drifts in the JAX package alike);
 12c. the CLI's I/O at matrix 6: `--msh` on the mesh written by
     write_gmsh (Stokes + 2 steps, physics checks); one 2-step run with
     `--save --vtu --checkpoint --checkpoint-every 2 --profile` (.vtu
     files, .pvd, the event table), `--resume` from it to step 4, and 4
     steps uninterrupted, whose solution_step0004.dat the resumed run must
     repeat bit for bit;
 13. the Schur tier: `run.main --matrix-id 8` at the float32 defaults
     ('auto' resolves to 'sch'), Stokes + 3 steps; K1 for every apply, each
     form on the tiled route, no plain call, Newton <= 3, mean GMRES per
     step within 0.5x-2x of the JAX package's 54.5 and equal to the port's
     own 46.0, K1 launches per form and route in one more step, peak
     device memory, the physics checks; then each K1 form of the run's own
     prep timed;
 14. the same with `--cgs2 pallas`, Stokes + 2 steps: K3 where V[:k+1]
     overflows shared memory, one launch per GMRES iteration, GMRES per
     step within 0.8x-1.25x of phase 13's;
 15. and 16. matrix 9 (Stokes + 2 steps, band around 72.2, the port's
     55.0) and matrix 10 (Stokes + 1 step, band around 89.5, the port's
     66.0), as phase 13, each form of the run's prep timed on both routes
     in turns;
 17. small-input reference: the golden 5-step trajectory of
     `tests/data_golden_trajectory.py` (reference-derived C) in float64, in
     flagship mode with cgs2='xla' and with cgs2='pallas' (K3 in float64),
     with the Schur tier forced, and on the block-Jacobi path, each run
     twice: the second run must repeat the first bit for bit;
 18. the benchmark entry point `bench.spmv_bench.main` at matrix 6 for
     spm2v, spm3v and spm4v (spmv is phase (l)): its lines, the fused K4
     variant within rel 1e-5 of the reference, K4 counted;
 19. the bench tools of the Schur tier at matrix 8: `transient_bench` (the
     product default, 3 steps; its TRANSIENT line, finite numbers) and
     `gmres_decomp --preconditioner auto` (every part of the 'sch' prep,
     the four GEMVs and K3; the tool's default is the JAX tool's 'tl');
 20. the discretization cache: `transient_bench --disc-cache` at matrix 8
     twice, the second run loading the cache, with equal counts and an
     equal final state bit for bit, both setup times printed;
 21. the solver options of ROADMAP slices 2/5, 10, 11, 12 and 13, each
     printing Newton and GMRES per step, its seconds and its kernel
     launches by form, none with a plain call on the card:
     (a) jacobian='reference' with the element-wise residual at matrix 6
         in float32 on 'tlp' through the solver API, Stokes + 2 steps,
         every step converged (Newton max_iter 30), assembly / prep / solve
         seconds per Newton iteration, the gap to the exact-Jacobian
         steps; one float64 residual, element-wise against operator form,
         at rel <= 1e-12;
     (b) the golden trajectory in reference mode (float64, 'bj', K2) at
         1e-8, repeated bit for bit;
     (c) `--coarse-basis linear --coarse-agg 128` at matrix 6 ('tlp'), 3
         steps, mean GMRES beside the JAX package's history;
     (d) smoothed aggregation (omega 0.6667) at matrix 3 in float64 on the
         card and on the CPU: equal counts, states at rel 1e-9; the SA
         prep at matrix 6 timed;
     (e) `--ca-gmres --ca-basis newton --restart 12` at matrix 6, 2 steps;
         the monomial basis for one Newton iteration (reported only);
     (f) `--deflation-k 16` at matrix 6, 2 steps, and with `--cgs2
         pallas`: one K3 launch per GMRES iteration, per step too;
     (g) CG on the matrix-6 pressure block + 0.1 I through K1's 1x1 form
         against the CPU solve at rel 1e-9; GMRES at matrix 3 with the
         ILU(0) host oracle against block-Jacobi (K2 matvec);
then distribution (ROADMAP slice 15), four shards on the one card:
 (h) K1 and K2 in their ghost-row forms: matrix 6 cut into 4 shards (and
     8 for K1), K1 4x4 f32 and f64 and 3x3 f32 (both routes where they
     fit), K2 A (81 diagonals) and S (123) f32 and f64, D^-1 (7) and A in
     bf16 with f32 x: every shard's rows equal the rows of one launch on
     the whole vector bit for bit and match the plain version within the
     bars of phases 3-4, also on random data with nonzero ghost rows; one
     interior shard timed flushed and L2-warm beside its plain version,
     cuSPARSE CSR on the shard's rows with their ghost columns, the
     shard's bound and the whole-matrix launch; the stored ghost width,
     the route and the plan printed;
 (i) `parallel.dryrun.dryrun_multichip(4, cuda:0)` (one f32 step, K1's
     ghost-row form) and `dryrun_wide(4, cuda:0)` (matrix 4 in f64: one
     step from one shared Stokes state against one device, rel < 1e-8,
     Newton equal, GMRES within 2);
 (j) the main distributed path: matrix 6 at the CLI's f32 defaults over 4
     shards, Stokes + 3 steps through `DistributedNavierStokesSolver`:
     'auto' resolves to plain two_level 'tlp' (with its warning), Newton
     <= 3, no plain call, the physics checks, K1 ghost-row launches per
     step; against the single-device solver at the same resolved config:
     Newton equal, mean GMRES within 0.8x-1.25x, states within rel 1e-4,
     both step times printed;
 (k) the scalar paths over 4 shards at matrix 6: the f64 CLI default 'bj'
     and 'tl' f32 (spmv='pallas'), Stokes + 2 steps each, K2's ghost-row
     form counted, 'tl' beside one device at the same resolved config
     (Newton equal, mean GMRES within 0.8x-1.25x); then CA-GMRES ('bj', neumann_order=0) on channel(64, 2,
     2), whose basis is the one-exchange power sweep (each sweep one K2
     ghost-row launch on the extended window): one solve of the first
     Newton system on the card and on the CPU from one state, GMRES
     within 1, solutions within rel 1e-6;
then the rest of the package (ROADMAP slice 16), no new kernel:
 (l) `spmv_bench.main` at matrix 6 (spmv, f32): the BCSR oracle and the
     block-ELL gather (plain PyTorch, as the JAX package's XLA forms) on
     the card within rel 1e-5 of the DIA reference, timed beside K2 and
     K1 in the same run;
 (m) `create_mat --matrix-id 3` on the card (float64) and on the CPU: the
     four files, each .mtx re-read by `read_mtx`, headers and (row, col)
     lists equal, values within rel 1e-12, the .npz likewise;
 (n) `layout_census --ids 1,...,8` with the native host library loaded:
     every column but build_s equal to `benchlogs/layout_census.txt`;
 (o) `accuracy_drift --matrix-id 4 --steps 12` on the card (f32 'tlp' K1
     against f64 'bj' K2), to the bars of `tests/test_accuracy.py`: max
     drift < 8e-3 and drift(12) < 1.5 drift(3); then `ca_bench --matrix-id
     6` ('tl', K2): the fixed-count table and the tolerance sweep;
then each phase's wall seconds, the launches of the solver-option and the
distributed paths, the kernel summary line and, last, the device line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from navierstokes_tpu_torch import native, run
from navierstokes_tpu_torch.bench import (
    accuracy_drift,
    ca_bench,
    create_mat,
    gmres_decomp,
    layout_census,
    spmv_bench,
    transient_bench,
)
from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu_torch.fem.assembly import (
    LINEAR_TERMS,
    assemble_dia_values,
    assemble_operator,
    assemble_residual,
    build_discretization,
)
from navierstokes_tpu_torch.fem.dirichlet import zero_rows_bcsr
from navierstokes_tpu_torch.io.dat import HEADER, read_petsc_vec
from navierstokes_tpu_torch.io.mtx import load_bcsr_npz, read_mtx
from navierstokes_tpu_torch.mesh.box import channel_mesh, scaling_series_mesh
from navierstokes_tpu_torch.mesh.gmsh import write_gmsh
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.ops import cgs2 as k3_ops
from navierstokes_tpu_torch.ops import cuda_lib
from navierstokes_tpu_torch.ops import dia as dia_ops
from navierstokes_tpu_torch.ops import grid_sync, mpk, mpk_fused
from navierstokes_tpu_torch.ops import plane_dia as pd
from navierstokes_tpu_torch.ops.block import block4_inverse
from navierstokes_tpu_torch.parallel import DistributedNavierStokesSolver
from navierstokes_tpu_torch.parallel import dryrun
from navierstokes_tpu_torch.parallel import partitioned as tpart
from navierstokes_tpu_torch.solvers import precond
from navierstokes_tpu_torch.solvers.cg import cg
from navierstokes_tpu_torch.solvers.coarse import build_aggregates
from navierstokes_tpu_torch.solvers.gmres import gmres
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
    "dia_spmv_bf16": ("dia", "navierstokes_tpu_torch/csrc/dia.cu",
                      "navierstokes_tpu/ops/pallas_dia.py:53"),
    "cgs2_project": ("cgs2", "navierstokes_tpu_torch/csrc/cgs2.cu",
                     "navierstokes_tpu/ops/cgs2_pallas.py:132"),
    "spmpv_dia": ("mpk", "navierstokes_tpu_torch/csrc/mpk.cu",
                  "navierstokes_tpu/ops/mpk_pallas.py:69"),
    # the ghost-row forms (x_prehalo=True: spmv_plane_pallas :225 and
    # spmv_dia_pallas :123 on pretiled data) of the same kernels
    "plane_spmv_halo": ("plane_dia",
                        "navierstokes_tpu_torch/csrc/plane_dia.cu",
                        "navierstokes_tpu/ops/plane_dia.py:113"),
    "dia_spmv_halo": ("dia", "navierstokes_tpu_torch/csrc/dia.cu",
                      "navierstokes_tpu/ops/pallas_dia.py:53"),
}
CPU = torch.device("cpu")
BARS = {torch.float32: 1e-5, torch.float64: 1e-12}
CLI_DEVICE = "cuda"         # the --device of every run.main call


PHASES = []                 # (name, start on the host clock), in order


def phase(name: str) -> None:
    PHASES.append((name, time.perf_counter()))
    print(f"--- {name}", flush=True)


def phase_seconds() -> None:
    """Each phase's wall seconds, and the whole run's."""
    end = time.perf_counter()
    starts = [t for _, t in PHASES[1:]] + [end]
    for (name, t0), t1 in zip(PHASES, starts):
        print(f"  {t1 - t0:8.1f} s  {name}")
    print(f"  {end - PHASES[0][1]:8.1f} s  in all")


def event_ms(fn, reps: int, flush=None, clean: bool = False,
             sleep_cycles: int = 20_000_000):
    """Median device time of fn() in ms over `reps` runs, from CUDA events.

    Before each run the stream sleeps, so the host enqueues the events and
    fn's launches while the device waits: the events bracket device work
    only, not Python launch overhead.  With `flush`, a buffer larger than
    the 50 MB L2 is rewritten first, so fn reads from device memory; that
    leaves the L2 full of modified lines, which fn's reads must first
    write back.  With `clean` the buffer is then read once more, so the L2
    holds unmodified lines and fn's reads are the only traffic."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
            if clean:
                flush.sum()
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


def csr_from_coo(rows, cols, vals, shape):
    """A CUDA CSR matrix from COO triplets (explicit zeros dropped)."""
    keep = vals != 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(
            torch.stack([rows[keep], cols[keep]]), vals[keep], shape)
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
    return csr_from_coo(torch.cat(rows), torch.cat(cols), torch.cat(vals),
                        (n, n))


def plane_csr(noffs, planes, nb, nbp, n_in=None):
    """A plane operator of n_out x n_in planes (4x4, or a Schur sub-block:
    3x3, 1x3, 3x1, 1x1) as CSR in plane ordering (row a*nbp + i, column
    b*nbp + i + D), live rows and in-range columns only."""
    n_out = planes.shape[0]
    n_in = n_out if n_in is None else n_in
    i = torch.arange(nb, device=planes.device)
    rows, cols, vals = [], [], []
    for a in range(n_out):
        for j, (b, d) in enumerate(pd.plane_terms(noffs, n_in)):
            ok = (i + d >= 0) & (i + d < nbp)
            rows.append(a * nbp + i[ok])
            cols.append(b * nbp + i[ok] + d)
            vals.append(planes[a, j, :nb][ok])
    return csr_from_coo(torch.cat(rows), torch.cat(cols), torch.cat(vals),
                        (n_out * nbp, n_in * nbp))


def time_all(kern, plain, library, flush) -> dict:
    """Flushed and L2-warm CUDA-event times of the kernel, its plain
    version and the library call (None where there is none)."""
    t = {"lib": None, "lib_flush": None}
    for name, fn in (("k", kern), ("p", plain), ("lib", library)):
        if fn is not None:
            t[name] = event_ms(fn, 25)
            t[name + "_flush"] = event_ms(fn, 25, flush=flush)
    return t


def route_turns(run_route, flush, reps: int = 25) -> dict:
    """Times of a kernel's two routes, 'rows' and 'tiled', taken in turns
    (rows, tiled, tiled, rows) so that drift of the card falls on both
    alike: L2-warm, flushed ("_flush"), and flushed with the L2 left clean
    ("_clean").  A route's time is the mean of its two medians."""
    t = {}
    for key, fl, clean in (("", None, False), ("_flush", flush, False),
                           ("_clean", flush, True)):
        turns = {"rows": [], "tiled": []}
        for route in ("rows", "tiled", "tiled", "rows"):
            turns[route].append(event_ms(lambda: run_route(route), reps,
                                         flush=fl, clean=clean))
        for route, ms in turns.items():
            t[route + key] = statistics.mean(ms)
            t[route + key + "_turns"] = ms
    return t


def time_routes(run_route, chosen: str, plain, library, flush) -> dict:
    """`time_all` for a kernel with two routes: "k" is the route the
    wrapper chooses for this operator."""
    t = time_all(None, plain, library, flush)
    t.update(route_turns(run_route, flush))
    for key in ("", "_flush", "_clean"):
        t["k" + key] = t[chosen + key]
    return t


def host_us_per_launch(run_route, launches: int = 2000) -> dict:
    """What a launch of each route costs the host, beside its device time:
    microseconds per call of the wrapper over `launches` calls in a loop
    with no sync, the routes in turns (rows, tiled, tiled, rows)."""
    us = {"rows": [], "tiled": []}
    for route in ("rows", "tiled", "tiled", "rows"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            run_route(route)
        us[route].append((time.perf_counter() - t0) / launches * 1e6)
    torch.cuda.synchronize()
    return us


def routes_line(t: dict) -> str:
    """The two routes' times, each turn shown: flushed, flushed with a
    clean L2, L2-warm."""
    def turns(key):
        return "/".join(f"{ms:.4f}" for ms in t[key + "_turns"])
    return " | ".join(
        f"{route} {turns(route + '_flush')} ms flushed, "
        f"{turns(route + '_clean')} ms flushed clean, {turns(route)} ms "
        "L2-warm" for route in ("tiled", "rows"))


def check_routes(label: str, run_route, ref, bar: float, pad=None,
                 routes=("rows", "tiled")) -> tuple:
    """The routes of a kernel against the plain result `ref`: rel error
    within `bar`, `pad(y)` (the padding rows) exactly zero, a second call
    equal bit for bit.  Returns {route: (rel, max_abs)} and whether the
    routes agree bit for bit."""
    errs, ys = {}, {}
    for route in routes:
        y = run_route(route)
        torch.cuda.synchronize()
        rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
        pad_max = 0.0 if pad is None else float(pad(y).abs().max())
        same = torch.equal(run_route(route), y)
        if not (y.dtype == ref.dtype and rel <= bar and pad_max == 0.0
                and same):
            raise AssertionError(
                f"{label} route {route}: rel {rel:.3e} (bar {bar}), padding "
                f"max {pad_max}, repeat bit for bit: {same}")
        errs[route] = (rel, float((y - ref).abs().max()))
        ys[route] = y
    return errs, all(torch.equal(ys[r], ys[routes[0]]) for r in routes)


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


_PTXAS = re.compile(
    r"Compiling entry function '(\S+)' for '(\S+)'.*?(\d+) bytes stack frame, "
    r"(\d+) bytes spill stores, (\d+) bytes spill loads\s+ptxas info\s+: "
    r"Used (\d+) registers([^\n]*)", re.DOTALL)
_KERNEL = re.compile(r"(?=(\d{1,2})([a-z]\w*?)I(\w+?)EEv)")


def ptxas_summary(log: str) -> str:
    """One line per kernel of what `nvcc -Xptxas -v` reported: registers,
    stack, spills, static shared memory.  Template arguments are decoded
    from the mangled name (f/d the dtype, Li<N>E an integer, Lb<0|1>E a
    bool)."""
    lines = []
    for name, arch, stack, st, ld, regs, rest in _PTXAS.findall(log):
        for m in _KERNEL.finditer(name):
            if len(m[2]) == int(m[1]):      # the length-prefixed identifier
                args = re.sub(r"L[ib](\d+)E", r",\1", m[3])
                args = {"f": "float", "d": "double"}.get(args[0], args[0]) \
                    + args[1:]
                name = f"{m[2]}<{args}>"
                break
        lines.append(f"  {name} ({arch}): {regs} registers, {stack} B stack, "
                     f"spill {st} B stores / {ld} B loads{rest}")
    return "\n".join(lines)


def build_phase():
    phase("build")
    t0 = time.perf_counter()
    libs = sorted({lib for lib, _, _ in KERNELS.values()})
    if libs != sorted(cuda_lib.SOURCES):
        raise AssertionError(f"KERNELS builds {libs}, the sources are "
                             f"{cuda_lib.SOURCES}")
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as ex:
        # the native host library (g++, not a kernel) builds beside them
        host = ex.submit(native.available)
        built = list(ex.map(cuda_lib.load, libs))
        if not host.result():
            raise AssertionError("the native host library did not load "
                                 "(no g++)")
    print(f"K1-K4 and the native host library built in "
          f"{time.perf_counter() - t0:.3f} s (parallel); pattern build: "
          f"{native.backend()}")
    for lib, (_, info) in zip(libs, built):
        print(f"{lib}: {info.seconds:.3f} s (cached={info.cached}) -> "
              f"{os.path.relpath(info.path, ROOT)}")
        print(ptxas_summary(info.log))


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
    # What any launch costs in these times: each route on one 128-row tile.
    one = torch.ones((1, 1, pd.PAD), dtype=torch.float32, device=dev)
    floor = {route: event_ms(lambda: pd.spmv_planes_cuda(
        (0,), one, one[0, 0], n_in=1, nb=pd.PAD, route=route), 25)
        for route in pd.ROUTES}
    print("launch floor (K1 1x1 on 128 rows, one offset, CUDA events): "
          + ", ".join(f"{r} {ms:.4f} ms" for r, ms in floor.items()))
    n_d = len(noffs)
    sel3 = [iD * 4 + b for iD in range(n_d) for b in range(3)]
    sel1 = [iD * 4 + 3 for iD in range(n_d)]
    forms = {
        "4x4": (p4_64, 4),
        "3x3": (p4_64[:3][:, sel3].contiguous(), 3),
        "1x1": (p4_64[3:4][:, sel1].contiguous(), 1),
    }
    rng = np.random.default_rng(2024)
    summary = {}
    for dtype, bar in BARS.items():
        for form, (planes64, n_in) in forms.items():
            data = planes64.to(dtype).contiguous()
            n_out = data.shape[0]
            x = torch.as_tensor(rng.standard_normal(n_in * nbp), dtype=dtype,
                                device=dev)
            x.reshape(n_in, nbp)[:, nb:] = 0
            chosen = pd.plane_route(noffs, data, x, n_in)
            plan = pd.tile_plan(noffs, n_out, n_in, nbp, data.element_size())

            def run_route(route):
                return pd.spmv_planes_cuda(noffs, data, x, n_in=n_in, nb=nb,
                                           route=route)

            ref = pd.spmv_planes_plain(noffs, data, x, n_in=n_in, nb=nb)
            label = f"K1 {form} {str(dtype)[6:]}"
            errs, same = check_routes(
                label, run_route, ref, bar,
                pad=lambda y: y.reshape(-1, nbp)[:, nb:])
            rel, abs_err = errs[chosen]

            def plain():
                pd.spmv_planes_plain(noffs, data, x, n_in=n_in, nb=nb)

            csr = plane_csr(noffs, data, nb, nbp)
            lib_rel = float(torch.linalg.norm(csr @ x - ref)
                            / torch.linalg.norm(ref))
            if lib_rel > bar:
                raise AssertionError(f"cuSPARSE CSR disagrees: {lib_rel}")

            def library():
                csr @ x
            t = time_routes(run_route, chosen, plain, library, flush)
            if form == "4x4":
                host = host_us_per_launch(run_route)
                print(f"{label}: a launch costs the host, in turns of 2,000 "
                      "launches in a loop with no sync, "
                      + ", ".join(f"{r} {'/'.join(f'{u:.1f}' for u in us)} us"
                                  for r, us in host.items()), flush=True)
            nbytes = data.element_size() * (data.numel() + (n_in + n_out)
                                            * nbp)
            t["bound"], t["bound_by"] = bound_ms(
                nbytes, 2 * NNZ_M6 * n_out * n_in / 16, dtype)
            nnz = NNZ_M6 * n_out * n_in // 16
            gfs = 2 * nnz / (t["k_flush"] * 1e-3) / 1e9
            lib_txt = (f" | cuSPARSE CSR {t['lib_flush']:.4f} ms flushed, "
                       f"{t['lib']:.4f} ms L2-warm")
            print(f"{label}: route {chosen} ({pd.plan_text(plan)} shared); rel "
                  + ", ".join(f"{r} {e[0]:.3e}" for r, e in errs.items())
                  + f", routes equal bit for bit: {same}; max_abs "
                  f"{abs_err:.3e} | {routes_line(t)} | {chosen}: "
                  f"{gfs:.1f} GF/s flushed | plain "
                  f"{t['p_flush']:.4f} ms flushed, {t['p']:.4f} ms L2-warm"
                  f"{lib_txt} | bound {t['bound']:.4f} ms ({t['bound_by']})",
                  flush=True)
            summary[(form, dtype)] = (abs_err, t)

        # Data that is nonzero where i + D leaves the matrix, and in the
        # padding rows: the zero fill of the tiled route's x window (and the
        # rows route's mask) must keep it out; the band crosses tile edges.
        data = torch.as_tensor(rng.standard_normal(tuple(p4_64.shape)),
                               dtype=dtype, device=dev)
        x = torch.as_tensor(rng.standard_normal(4 * nbp), dtype=dtype,
                            device=dev)
        ref = pd.spmv_planes_plain(noffs, data, x, n_in=4, nb=nb)
        errs, _ = check_routes(
            f"K1 random data {dtype}",
            lambda route: pd.spmv_planes_cuda(noffs, data, x, n_in=4, nb=nb,
                                              route=route),
            ref, bar, pad=lambda y: y.reshape(-1, nbp)[:, nb:])
        print(f"K1 4x4 {str(dtype)[6:]}, random data nonzero outside the "
              "matrix and in the padding rows: rel "
              + ", ".join(f"{r} {e[0]:.3e}" for r, e in errs.items()))
    print("K1: padding rows exactly 0 and every call repeated bit for bit, "
          "both routes")
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
    summary = {}

    def check(label, offsets, data, x, bar):
        """K2 against the plain version: rel error within `bar`, a second
        call equal bit for bit; returns (ref, rel, max_abs)."""
        y = dia_ops.spmv_dia(offsets, data, x)
        torch.cuda.synchronize()
        ref = dia_ops.spmv_dia_plain(offsets, data, x)
        rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
        same = torch.equal(dia_ops.spmv_dia(offsets, data, x), y)
        if not (y.dtype == data.dtype and rel <= bar and same):
            raise AssertionError(f"{label}: rel {rel:.3e} (bar {bar}), "
                                 f"repeat bit for bit: {same}")
        return ref, rel, float((y - ref).abs().max())

    for dtype, bar in BARS.items():
        for form, (offsets, d64) in forms.items():
            data = d64.to(dtype).contiguous()
            x = torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                device=dev)
            label = f"K2 {form} {str(dtype)[6:]} (K={len(offsets)})"
            ref, rel, abs_err = check(label, offsets, data, x, bar)
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
            print(f"{label}: rel {rel:.3e} max_abs {abs_err:.3e} | kernel "
                  f"{t['k_flush']:.4f} ms flushed, {t['k']:.4f} ms L2-warm | "
                  f"plain {t['p_flush']:.4f} / {t['p']:.4f} ms | cuSPARSE "
                  f"CSR (nnz {csr.values().numel()}) {t['lib_flush']:.4f} / "
                  f"{t['lib']:.4f} ms | bound {t['bound']:.4f} ms "
                  f"({t['bound_by']})", flush=True)
            summary[(form, dtype)] = (abs_err, t)

        # Data that is nonzero where i + off leaves the matrix: the mask
        # per load must keep it out.
        offsets = pat.offsets
        data = torch.as_tensor(rng.standard_normal((len(offsets), n)),
                               dtype=dtype, device=dev)
        x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
        _, rel, _ = check(f"K2 random data {dtype}", offsets, data, x, bar)
        print(f"K2 A's offsets {str(dtype)[6:]}, random data nonzero outside "
              f"the matrix: rel {rel:.3e}")
    print("K2: every call repeated bit for bit")
    return summary


def pair_turns(fa, fb, flush, reps: int = 25) -> dict:
    """Device times of two functions taken in turns (a, b, b, a), flushed
    ("_flush") and L2-warm: each the mean of its two medians, with the
    turns."""
    t = {}
    for key, fl in (("", None), ("_flush", flush)):
        turns = {"a": [], "b": []}
        for name in ("a", "b", "b", "a"):
            turns[name].append(event_ms(fa if name == "a" else fb, reps,
                                        flush=fl))
        for name, ms in turns.items():
            t[name + key] = statistics.mean(ms)
            t[name + key + "_turns"] = ms
    return t


def k2_bf16_phase(dev, mesh, pat, data64, flush) -> dict:
    """K2's bf16 form (matvec_dtype) on the matrix-6 A (81 diagonals) and
    S = D^-1 A (123), the operator rounded to bf16, x in f32 and in f64:
    against its plain version (rel 1e-6 with f32 x, 1e-13 with f64 x), a
    second call equal bit for bit, also on random data nonzero where
    i + off leaves the matrix; timed in turns with the f32 K2 on the same
    operator, with the bound and cuSPARSE f32 beside it."""
    phase("K2 bf16 form against its plain version (matrix-6 A and S)")
    print("No single PyTorch call computes bf16 operator data times an f32 "
          "or f64 x, so the bf16 form has no library time; the f32 K2 and "
          "cuSPARSE's f32 CSR SpMV on the same operator stand beside it.")
    nb, n = mesh.nv, 4 * mesh.nv
    inv = block4_inverse(diag_blocks_from_dia(pat.offsets, data64, nb),
                         pivot_eps=1e-300, shift=1e-8)
    s_off, s_data = scale_rows_dia(pat, data64, inv)
    forms = {"A": (pat.offsets, data64), "S": (s_off, s_data)}
    bars = {torch.float32: 1e-6, torch.float64: 1e-13}
    rng = np.random.default_rng(2077)
    summary = {}

    def check(label, offsets, data, x, bar):
        y = dia_ops.spmv_dia(offsets, data, x)
        torch.cuda.synchronize()
        ref = dia_ops.spmv_dia_plain(offsets, data, x)
        rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
        same = torch.equal(dia_ops.spmv_dia(offsets, data, x), y)
        if not (y.dtype == x.dtype and rel <= bar and same):
            raise AssertionError(f"{label}: rel {rel:.3e} (bar {bar}), "
                                 f"repeat bit for bit: {same}")
        return ref, rel, float((y - ref).abs().max())

    for form, (offsets, d64) in forms.items():
        data16 = d64.to(torch.bfloat16).contiguous()
        data32 = d64.to(torch.float32).contiguous()
        csr = dia_csr(offsets, data32)
        for x_dtype, bar in bars.items():
            x = torch.as_tensor(rng.standard_normal(n), dtype=x_dtype,
                                device=dev)
            label = (f"K2 bf16 {form} x {str(x_dtype)[6:]} "
                     f"(K={len(offsets)})")
            _, rel, abs_err = check(label, offsets, data16, x, bar)
            x32 = x.to(torch.float32)

            def bf16():
                dia_ops.spmv_dia(offsets, data16, x)

            def f32():
                dia_ops.spmv_dia(offsets, data32, x32)

            def plain():
                dia_ops.spmv_dia_plain(offsets, data16, x)

            t = pair_turns(bf16, f32, flush)
            t["k"], t["k_flush"] = t["a"], t["a_flush"]
            t["p"] = event_ms(plain, 25)
            t["p_flush"] = event_ms(plain, 25, flush=flush)
            t["lib"] = t["lib_flush"] = None
            cus = (event_ms(lambda: csr @ x32, 25, flush=flush),
                   event_ms(lambda: csr @ x32, 25))
            in_range = sum(n - abs(d) for d in offsets)
            t["bound"], t["bound_by"] = bound_ms(
                data16.numel() * 2 + 2 * n * x.element_size(),
                2 * in_range, x_dtype)
            f32_bound, _ = bound_ms(data32.numel() * 4 + 2 * n * 4,
                                    2 * in_range, torch.float32)

            def turns(key):
                return "/".join(f"{ms:.4f}" for ms in t[key + "_turns"])

            print(f"{label}: rel {rel:.3e} max_abs {abs_err:.3e} | bf16 "
                  f"{turns('a_flush')} ms flushed, {turns('a')} ms L2-warm "
                  f"| f32 K2 {turns('b_flush')} / {turns('b')} ms (bound "
                  f"{f32_bound:.4f}) | plain {t['p_flush']:.4f} / "
                  f"{t['p']:.4f} ms | cuSPARSE f32 {cus[0]:.4f} / "
                  f"{cus[1]:.4f} ms | bound {t['bound']:.4f} ms "
                  f"({t['bound_by']})", flush=True)
            summary[(form, x_dtype)] = (abs_err, t)

        # random data nonzero where i + off leaves the matrix
        rand16 = torch.as_tensor(rng.standard_normal((len(offsets), n)),
                                 device=dev).to(torch.bfloat16)
        for x_dtype, bar in bars.items():
            x = torch.as_tensor(rng.standard_normal(n), dtype=x_dtype,
                                device=dev)
            _, rel, _ = check(f"K2 bf16 {form} random", offsets, rand16, x,
                              bar)
            print(f"K2 bf16 {form}'s offsets x {str(x_dtype)[6:]}, random "
                  f"data nonzero outside the matrix: rel {rel:.3e}")
    print("K2 bf16: every call repeated bit for bit")
    return summary


def route_sweep_phase(dev, pat, flush):
    """Both routes of K1 away from matrix 6's size, on random operators
    with matrix 6's node offsets: a quarter of its rows (small tiles) and
    4x and 8x (persistent blocks that walk several tiles, two window
    buffers).  Each against the plain version and the other route, then
    timed."""
    phase("route sweep: K1, both routes, at 1/4x, 4x and 8x the rows of "
          "matrix 6")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2028)
    noffs = pd.node_offsets_from_scalar(pat.offsets)
    for dtype, bar in BARS.items():
        for mult in (0.25, 4, 8):
            nbp = int(29_440 * mult)
            nb = nbp - 37
            data = torch.randn((4, 4 * len(noffs), nbp), dtype=dtype,
                               device=dev, generator=gen)
            x = torch.randn(4 * nbp, dtype=dtype, device=dev, generator=gen)
            label = f"K1 4x4 {str(dtype)[6:]} nbp={nbp}"
            plan = pd.tile_plan(noffs, 4, 4, nbp, data.element_size())

            def run_route(route):
                return pd.spmv_planes_cuda(noffs, data, x, n_in=4, nb=nb,
                                           route=route)

            errs, same = check_routes(
                label, run_route,
                pd.spmv_planes_plain(noffs, data, x, n_in=4, nb=nb), bar,
                pad=lambda y: y.reshape(-1, nbp)[:, nb:])
            if not same:
                raise AssertionError(f"{label}: the routes differ")
            t = route_turns(run_route, flush, reps=9)
            print(f"{label}: {pd.plan_text(plan)}, {plan.windows} window "
                  f"buffer(s); rel {errs['tiled'][0]:.3e}, routes "
                  f"equal bit for bit | {routes_line(t)}", flush=True)


def schur_prep(matrix_id: int, dev):
    """The 'sch' prep of matrix `matrix_id`'s exact Jacobian in float64,
    with schur_shape='full' so that it holds all five K1 forms of the
    tier (the prep of `run.main`, which prepares the Stokes and the Newton
    operators the same way)."""
    kr = SolverConfig(preconditioner="schur", spmv="plane",
                      schur_shape="full")
    cfg = NSConfig(dtype="float64", krylov=kr, stokes_krylov=kr)
    solver = NavierStokesSolver(scaling_series_mesh(matrix_id), cfg,
                                device=dev)
    solver._ensure_prepared()
    return solver._exact_prep


def schur_forms(prep) -> dict:
    """{form: (node offsets, planes, n_in)}: every K1 form of a 'sch'
    prep, the 3x1 A_up only where the shape is 'full'."""
    noffs = prep.node_offsets
    forms = {"4x4 A": (noffs, prep.p4, 4), "3x3 F": (noffs, prep.p_f, 3),
             "1x3 A_pu": (noffs, prep.p_b, 3),
             "1x1 S_hat": (prep.s_offsets, prep.s_planes, 1)}
    if prep.p_g is not None:
        forms["3x1 A_up"] = (noffs, prep.p_g, 1)
    return forms


def k1_form(label: str, offs, data, n_in: int, nb: int, flush, rng,
            routes: bool = False) -> tuple:
    """One K1 form on x random in its live rows: against its plain version
    (within BARS, padding rows exactly 0, a second call bit for bit), then
    timed flushed and L2-warm beside the plain version, cuSPARSE CSR and
    the bound.  The route the wrapper chooses, or with `routes` both
    routes in turns, which must agree bit for bit.  Returns (max_abs, t,
    chosen route)."""
    dtype = data.dtype
    n_out, _, nbp = data.shape
    x = torch.as_tensor(rng.standard_normal(n_in * nbp), dtype=dtype,
                        device=data.device)
    x.reshape(n_in, nbp)[:, nb:] = 0
    chosen = pd.plane_route(offs, data, x, n_in)
    plan = pd.tile_plan(offs, n_out, n_in, nbp, data.element_size())
    routes = routes and plan is not None

    def run_route(route):
        return pd.spmv_planes_cuda(offs, data, x, n_in=n_in, nb=nb,
                                   route=route)

    def plain():
        return pd.spmv_planes_plain(offs, data, x, n_in=n_in, nb=nb)

    ref = plain()
    errs, same = check_routes(label, run_route, ref, BARS[dtype],
                              pad=lambda y: y.reshape(-1, nbp)[:, nb:],
                              routes=("rows", "tiled") if routes
                              else (chosen,))
    if not same:
        raise AssertionError(f"{label}: the routes differ")
    csr = plane_csr(offs, data, nb, nbp, n_in)
    lib_rel = float(torch.linalg.norm(csr @ x - ref) / torch.linalg.norm(ref))
    if lib_rel > BARS[dtype]:
        raise AssertionError(f"{label}: cuSPARSE CSR disagrees: {lib_rel}")

    def library():
        csr @ x

    if routes:
        t = time_routes(run_route, chosen, plain, library, flush)
    else:
        t = time_all(lambda: run_route(chosen), plain, library, flush)
    in_range = sum(max(0, nb - abs(d)) for d in offs)
    t["bound"], t["bound_by"] = bound_ms(
        data.element_size() * (data.numel() + (n_in + n_out) * nbp),
        2 * n_out * n_in * in_range, dtype)
    how = (f"{pd.plan_text(plan)} shared" if plan
           else "the tiled plan does not fit")
    times = routes_line(t) if routes else (
        f"kernel {t['k_flush']:.4f} ms flushed, {t['k']:.4f} ms L2-warm")
    print(f"{label} ({len(offs)} offsets {min(offs)}..{max(offs)}): route "
          f"{chosen} ({how}); rel "
          + ", ".join(f"{r} {e[0]:.3e}" for r, e in errs.items())
          + f"; max_abs {errs[chosen][1]:.3e} | {times} | plain "
          f"{t['p_flush']:.4f} / {t['p']:.4f} ms | cuSPARSE CSR "
          f"{t['lib_flush']:.4f} / {t['lib']:.4f} ms | bound "
          f"{t['bound']:.4f} ms ({t['bound_by']})", flush=True)
    return errs[chosen][1], t, chosen


def k1_schur_phase(dev, flush) -> dict:
    """K1 on the Schur tier's forms: S_hat 1x1 on its 65 node offsets at
    matrix 6 and 8 shapes, both routes, f32 and f64, and on random data
    nonzero outside the matrix; the other four forms at matrix 8 by the
    route the wrapper chooses."""
    phase("K1 on the Schur tier's forms (S_hat on its 65 offsets at matrix "
          "6 and 8 shapes; the sub-blocks at matrix 8)")
    rng = np.random.default_rng(2030)
    summary = {}
    for mid in (6, 8):
        t0 = time.perf_counter()
        prep = schur_prep(mid, dev)
        nb, nbp = prep.nb, prep.nbp
        print(f"matrix {mid}: 'sch' prep in float64 "
              f"{time.perf_counter() - t0:.3f} s; nb={nb} nbp={nbp} node offsets {len(prep.node_offsets)}, "
              f"S_hat offsets {len(prep.s_offsets)}", flush=True)
        if len(prep.s_offsets) != 65:
            raise AssertionError(f"S_hat has {len(prep.s_offsets)} offsets")
        forms = schur_forms(prep)
        for form, (offs, planes, n_in) in forms.items():
            for dtype in BARS:
                if form != "1x1 S_hat" and (mid != 8
                                            or dtype != torch.float32):
                    continue
                data = planes.to(dtype).contiguous()
                summary[(mid, form, dtype)] = k1_form(
                    f"K1 m{mid} {form} {str(dtype)[6:]}", offs, data, n_in,
                    nb, flush, rng, routes=form == "1x1 S_hat")
        # Data nonzero where i + D leaves the matrix and in the padding
        # rows: each segment of the clustered x window must hold exact
        # zeros there, as the rows route's mask does.
        for form in ("1x1 S_hat", "1x3 A_pu", "3x3 F"):
            offs, planes, n_in = forms[form]
            for dtype, bar in BARS.items():
                data = torch.as_tensor(
                    rng.standard_normal(tuple(planes.shape)), dtype=dtype,
                    device=dev)
                x = torch.as_tensor(rng.standard_normal(n_in * nbp),
                                    dtype=dtype, device=dev)
                ref = pd.spmv_planes_plain(offs, data, x, n_in=n_in, nb=nb)
                errs, same = check_routes(
                    f"K1 m{mid} {form} random data {dtype}",
                    lambda route: pd.spmv_planes_cuda(
                        offs, data, x, n_in=n_in, nb=nb, route=route),
                    ref, bar, pad=lambda y: y.reshape(-1, nbp)[:, nb:])
                if not same:
                    raise AssertionError(f"{form} random data: the routes "
                                         "differ")
                print(f"K1 m{mid} {form} {str(dtype)[6:]}, random data "
                      "nonzero outside the matrix and in the padding rows: "
                      "rel "
                      + ", ".join(f"{r} {e[0]:.3e}" for r, e in errs.items())
                      + ", routes equal bit for bit", flush=True)
        del prep, forms
    print("K1 Schur forms: padding rows exactly 0, every call repeated bit "
          "for bit, the two routes equal bit for bit (S_hat on its own "
          "data; S_hat, 1x3 and 3x3 on random data)")
    return summary


def coop_floor(grid: int, smem: int, barriers, dev) -> dict:
    """Device ms of grid_sync's empty kernel, launched as K3 and K4 are
    (`grid` blocks, `smem` bytes each), per barrier count: the floor of a
    persistent launch, beside the 5.2 us of a plain one (K1's phase)."""
    return {b: event_ms(lambda: grid_sync.empty_launch(grid, smem, b, dev),
                        25) for b in barriers}


def floor_text(floor: dict) -> str:
    return ", ".join(f"{b} barrier{'s' * (b != 1)} {ms:.4f} ms"
                     for b, ms in floor.items())


def k3_phase(dev, flush):
    phase("K3 against its plain version (matrix-6 Krylov shapes and the "
          "Schur tier's n)")
    rng = np.random.default_rng(2026)
    summary = {}
    # (dtype, n, timed (k, compensated)): matrix 6 in the plane layout
    # (f32) and the scalar one (f64); matrix 8's n, where V[:k+1] does not
    # fit in shared memory and rows R..k are read again in every phase.
    every = [(k, c) for k in (0, 15, 29) for c in (False, True)]
    cases = ((torch.float32, 117_760, every), (torch.float64, 117_500, every),
             (torch.float32, 511_024, [(15, False), (29, False)]),
             (torch.float64, 511_024, [(29, False)]))
    for dtype, n, timed in cases:
        bar = BARS[dtype]
        s = torch.empty((), dtype=dtype).element_size()
        # orthonormal rows 0..29, as GMRES keeps them
        q = torch.linalg.qr(torch.as_tensor(rng.standard_normal((n, 30))))[0]
        V = torch.zeros((31, n), dtype=dtype, device=dev)
        V[:30] = q.T.to(dtype).to(dev)
        w = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
        for k, comp in every:
            poisoned = V.clone()
            poisoned[k + 1:] = float("nan")
            w2, h = k3_ops.cgs2_project(poisoned, w, k, compensated=comp)
            torch.cuda.synchronize()
            w2_r, h_r = k3_ops.cgs2_project_plain(V, w, k, compensated=comp)
            rel = max(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
                      for a, b in ((w2, w2_r), (h, h_r)))
            abs_err = max(float((w2 - w2_r).abs().max()),
                          float((h - h_r).abs().max()))
            again = k3_ops.cgs2_project(poisoned, w, k, compensated=comp)
            if not (rel <= bar and bool((h[k + 1:] == 0).all())
                    and torch.equal(again[0], w2)
                    and torch.equal(again[1], h)):
                raise AssertionError(
                    f"K3 {dtype} n={n} k={k} comp={comp}: rel {rel:.3e} "
                    f"(bar {bar}), h beyond k {h[k + 1:].abs().max()}, "
                    f"repeat bit for bit: {torch.equal(again[0], w2)}")
            pl, grid = k3_ops.device_plan(n, k, dtype, comp, dev)
            label = (f"K3 {str(dtype)[6:]} n={n} k={k} "
                     f"{'compensated' if comp else 'plain sums'} ({grid} "
                     f"blocks, slab {pl.ld}, {pl.rows}/{k + 1} rows resident, "
                     f"{pl.smem} B shared, "
                     f"{k3_ops.passes_over_v(k, pl.rows):.2f} passes over V)")
            if (k, comp) not in timed:
                print(f"{label}: rel {rel:.3e} max_abs {abs_err:.3e}",
                      flush=True)
                continue

            def kern():
                k3_ops.cgs2_project(V, w, k, compensated=comp)

            def plain():
                k3_ops.cgs2_project_plain(V, w, k, compensated=comp)

            def library():
                vk = V[:k + 1]
                h1 = vk @ w
                w1 = w - vk.T @ h1
                h2 = vk @ w1
                return w1 - vk.T @ h2

            t = time_all(kern, plain, library, flush)
            # the function's bound: V[:k+1] read once, w in, w2 and h out
            t["bound"], t["bound_by"] = bound_ms(
                ((k + 3) * n + V.shape[0]) * s, 8 * (k + 1) * n, dtype)
            print(f"{label}: rel {rel:.3e} max_abs {abs_err:.3e} | kernel "
                  f"{t['k_flush']:.4f} ms flushed, {t['k']:.4f} ms L2-warm | "
                  f"plain {t['p_flush']:.4f} / {t['p']:.4f} ms | four cuBLAS "
                  f"GEMVs {t['lib_flush']:.4f} / {t['lib']:.4f} ms | bound "
                  f"{t['bound']:.4f} ms ({t['bound_by']})", flush=True)
            summary[(dtype, n, k, comp)] = (abs_err, t)
            if (dtype, n, k, comp) == (torch.float32, 117_760, 15, False):
                floor = coop_floor(grid, pl.smem, (0, 1, 2), dev)
                print(f"K3's cooperative launch floor (empty kernel, {grid} "
                      f"blocks, {pl.smem} B shared; K3 has 2 barriers): "
                      f"{floor_text(floor)}", flush=True)
                us = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(2000):
                        kern()
                    us.append((time.perf_counter() - t0) / 2000 * 1e6)
                torch.cuda.synchronize()
                print("K3 f32 k=15: a call costs the host "
                      f"{'/'.join(f'{u:.1f}' for u in us)} us (two turns of "
                      "2,000 calls in a loop with no sync)", flush=True)
    print("K3: h beyond k exactly 0 with NaN rows above k; every call "
          "repeats bit for bit")
    return summary


def k4_check(label, offsets, data, x, p, bar):
    """K4 against p chained K2 launches (bit for bit, in two calls) and its
    plain version (rel within `bar`); returns (rel, max_abs)."""
    z = mpk_fused.spmpv_dia(offsets, data, x, power=p)
    torch.cuda.synchronize()
    chained = mpk.matrix_power(offsets, data, x, p)
    ref = mpk_fused.spmpv_dia_plain(offsets, data, x, power=p)
    rel = float(torch.linalg.norm(z - ref) / torch.linalg.norm(ref))
    same = torch.equal(z, chained)
    again = torch.equal(mpk_fused.spmpv_dia(offsets, data, x, power=p), z)
    if not (rel <= bar and same and again):
        raise AssertionError(f"{label} p={p}: rel {rel:.3e} to plain (bar "
                             f"{bar}), equal to chained K2: {same}, repeat "
                             f"bit for bit: {again}")
    return rel, float((z - ref).abs().max())


def k4_phase(dev, pat, data64, flush):
    phase("K4 against chained K2 and its plain version (matrix-6 A)")
    offsets = pat.offsets
    n = data64.shape[1]
    in_range = sum(n - abs(d) for d in offsets)
    rng = np.random.default_rng(2027)
    summary = {}
    for dtype in (torch.float32, torch.float64):
        bar = BARS[dtype]
        data = data64.to(dtype).contiguous()
        csr = dia_csr(offsets, data)
        x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
        pl, grid = mpk_fused.device_plan(n, offsets, dtype, dev)
        floor = coop_floor(grid, pl.smem, (1, 2, 3), dev)
        print(f"K4 {str(dtype)[6:]}: {grid} blocks, slab {pl.ld} rows, "
              f"source window {pl.window} values, {pl.resident}/"
              f"{len(offsets)} diagonals resident, {pl.smem} B shared; "
              f"cooperative launch floor (empty kernel, same grid "
              f"and shared memory; K4 has p - 1 barriers): "
              f"{floor_text(floor)}", flush=True)
        for p in mpk_fused.POWERS:
            rel, abs_err = k4_check(f"K4 {dtype}", offsets, data, x, p, bar)

            def kern():
                mpk_fused.spmpv_dia(offsets, data, x, power=p)

            def plain():
                mpk_fused.spmpv_dia_plain(offsets, data, x, power=p)

            def k2_chain():
                mpk.matrix_power(offsets, data, x, p)

            def library():
                y = x
                for _ in range(p):
                    y = csr @ y

            t = time_all(kern, plain, library, flush)
            t["k2"] = event_ms(k2_chain, 25)
            t["k2_flush"] = event_ms(k2_chain, 25, flush=flush)
            t["bound"], t["bound_by"] = bound_ms(
                data.element_size() * (data.numel() + 2 * n),
                2 * p * in_range, dtype)
            passes = mpk_fused.passes_over_a(len(offsets), pl.resident, p)
            print(f"K4 {str(dtype)[6:]} p={p} ({passes:.2f} passes over A vs "
                  f"{p} chained): equal to {p} chained K2 bit for bit, rel "
                  f"{rel:.3e} to plain, max_abs {abs_err:.3e} | kernel "
                  f"{t['k_flush']:.4f} ms flushed, {t['k']:.4f} ms L2-warm | "
                  f"plain {t['p_flush']:.4f} / {t['p']:.4f} ms | {p} chained "
                  f"K2 {t['k2_flush']:.4f} / {t['k2']:.4f} ms | {p} chained "
                  f"cuSPARSE CSR {t['lib_flush']:.4f} / {t['lib']:.4f} ms | "
                  f"bound {t['bound']:.4f} ms ({t['bound_by']}) | floor with "
                  f"{p - 1} barrier{'s' * (p > 2)} {floor[p - 1]:.4f} ms",
                  flush=True)
            summary[(dtype, p)] = (abs_err, t)
        # A halo too wide for overlapping row tiles in shared memory, and
        # a span too wide for K4's source window there, on random data
        # that is nonzero outside the matrix.
        for wide in ((-6000, -2607, -1, 0, 1, 2607, 6000),
                     (-20_000, -1, 0, 1, 20_000)):
            rdata = torch.as_tensor(rng.standard_normal((len(wide), n)) / 3,
                                    dtype=dtype, device=dev)
            label = f"K4 {str(dtype)[6:]} offsets +-{wide[-1]}"
            rels = [k4_check(label, wide, rdata, x, p, bar)[0]
                    for p in mpk_fused.POWERS]
            wpl, _ = mpk_fused.device_plan(n, wide, dtype, dev)
            print(f"{label} (source window {wpl.window} values), random "
                  "data nonzero outside the matrix: equal to chained K2 bit "
                  "for bit, rel to plain "
                  + ", ".join(f"{r:.3e}" for r in rels), flush=True)
    print("K4: equal to p chained K2 launches bit for bit at every p, dtype "
          "and halo; every call repeats bit for bit")
    return summary


def reset_counters():
    pd.reset_counters()
    dia_ops.reset_counters()
    k3_ops.reset_counters()
    mpk_fused.reset_counters()


def counters() -> dict:
    return {"K1": pd.kernel_launches,
            "K1 tiled": pd.route_launches["tiled"],
            "K1 rows": pd.route_launches["rows"],
            "K1 halo": pd.halo_launches,
            "K1 forms": dict(pd.form_launches),
            "K1 plain": pd.plain_calls,
            "K2": dia_ops.kernel_launches,
            "K2 halo": dia_ops.halo_launches,
            "K2 forms": dict(dia_ops.form_launches),
            "K2 plain": dia_ops.plain_calls,
            "K3": k3_ops.kernel_launches, "K3 plain": k3_ops.plain_calls,
            "K4": mpk_fused.kernel_launches,
            "K4 plain": mpk_fused.plain_calls}


def no_plain_calls(counts: dict) -> bool:
    return not any(v for key, v in counts.items() if key.endswith("plain"))


def drive(label: str, argv: list, n_steps: int, max_newton=3,
          stokes_must_converge=True):
    """run.main with the kernel counters reset just before and read just
    after, then the step, Stokes and physics checks; returns (RunOutput,
    counts)."""
    phase(label)
    with tempfile.TemporaryDirectory() as save_dir:
        reset_counters()
        out = run.main(argv + ["--steps", str(n_steps), "--save",
                               "--save-dir", save_dir, "--device",
                               CLI_DEVICE])
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
    check_state(out.solver.disc.mesh, out.u)


def check_state(mesh, u) -> None:
    """The repo's physics checks on a state: finite, the inlet profile and
    the obstacle's zero velocity exact, downstream flow."""
    u = u.detach().cpu().numpy()
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


PLANE_ARGV = ["--matrix-id", "6", "--re", "300", "--dt", "1e-3", "--delta",
              "0.05", "--dtype", "float32"]


def plane_path_phase():
    out, counts = drive("plane path: run.main --matrix-id 6, float32, "
                        "Stokes + 5 steps ('tlp')", PLANE_ARGV, 5)
    lin = mean_lin(out)
    print(f"mean GMRES iterations per step {lin:.1f} (JAX package on TPU "
          f"v5e: {JAX_LIN_PER_STEP}, BENCH_r05, for comparison only)")
    if out.solver.prep_kind != "tlp":
        raise AssertionError(f"prep {out.solver.prep_kind}")
    if not 0.5 * JAX_LIN_PER_STEP <= lin <= 2 * JAX_LIN_PER_STEP:
        raise AssertionError(f"mean GMRES/step {lin} outside 0.5x-2x of "
                             f"{JAX_LIN_PER_STEP}")
    if counts["K1 tiled"] <= 0 or counts["K1 rows"] or counts["K3"] \
            or not no_plain_calls(counts):
        raise AssertionError(f"kernel counts {counts}")
    return counts["K1"], lin, out


def tf32_flags() -> tuple:
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def tf32_phase(off) -> None:
    """Phase 8's 'tlp' run with the caller's TF32 on: the solver turns it
    off for its own work only, so Stokes and every step take the same
    GMRES iterations and end in the same state bit for bit, and the
    caller's two flags read True after."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        out, _ = drive("plane path with the caller's TF32 on: run.main "
                       "--matrix-id 6, float32, Stokes + 5 steps ('tlp')",
                       PLANE_ARGV, 5)
        after = tf32_flags()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def counts(o):
        return [o.solver.stokes_result.iters] + [
            (st.iters, st.lin_iters) for _, st, _ in o.solver.history]
    same = torch.equal(out.u, off.u)
    print(f"TF32 on: Stokes GMRES and (Newton, GMRES) per step "
          f"{counts(out)}; TF32 off: {counts(off)}; states equal bit for "
          f"bit: {same}; the caller's flags after the run: {after}")
    if counts(out) != counts(off) or not same or after != (True, True):
        raise AssertionError("the solver's work depends on the caller's "
                             "TF32 flags, or changed them")


def plane_cgs2_phase(plane_lin: float):
    out, counts = drive("plane path with the fused CGS2: run.main "
                        "--matrix-id 6 --cgs2 pallas, float32, Stokes + 5 "
                        "steps ('tlp', K3)",
                        ["--matrix-id", "6", "--re", "300", "--dt", "1e-3",
                         "--delta", "0.05", "--dtype", "float32", "--cgs2",
                         "pallas"], 5)
    lin = mean_lin(out)
    print(f"mean GMRES iterations per step {lin:.1f} (cgs2='xla' plane path "
          f"{plane_lin:.1f})")
    if out.solver.prep_kind != "tlp" or out.solver.cfg.krylov.cgs2 != \
            "pallas":
        raise AssertionError(f"prep {out.solver.prep_kind}, "
                             f"{out.solver.cfg.krylov}")
    if not 0.8 * plane_lin <= lin <= 1.25 * plane_lin:
        raise AssertionError(f"mean GMRES/step {lin} outside 0.8x-1.25x of "
                             f"the cgs2='xla' plane path's {plane_lin}")
    if counts["K3"] <= 0 or counts["K1 tiled"] <= 0 or counts["K1 rows"] \
            or not no_plain_calls(counts):
        raise AssertionError(f"kernel counts {counts}")
    # one launch per projection, one projection per GMRES iteration (a
    # breakdown adds the one whose column is dropped)
    gmres = out.solver.stokes_result.iters + sum(
        st.lin_iters for _, st, _ in out.solver.history)
    print(f"K3 launches {counts['K3']} for {gmres} GMRES iterations "
          f"(Stokes + steps): {counts['K3'] / gmres:.3f} per iteration")
    if not gmres <= counts["K3"] <= 1.05 * gmres:
        raise AssertionError(f"{counts['K3']} K3 launches for {gmres} GMRES "
                             "iterations")
    return counts["K3"]


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
    if counts["K2"] <= 0 or counts["K1"] or counts["K3"] \
            or not no_plain_calls(counts):
        raise AssertionError(f"kernel counts {counts}")
    return counts["K2"]


def scalar_comp_phase():
    out, counts = drive("scalar two-level path with compensated CGS2: "
                        "run.main --matrix-id 6 --spmv pallas --cgs2 "
                        "pallas_comp, float32, Stokes + 2 steps ('tl', K3)",
                        ["--matrix-id", "6", "--spmv", "pallas", "--cgs2",
                         "pallas_comp", "--dtype", "float32"], 2)
    if out.solver.prep_kind != "tl" or out.solver.cfg.krylov.cgs2 != \
            "pallas_comp":
        raise AssertionError(f"prep {out.solver.prep_kind}, "
                             f"{out.solver.cfg.krylov}")
    if counts["K3"] <= 0 or counts["K2"] <= 0 or counts["K1"] \
            or not no_plain_calls(counts):
        raise AssertionError(f"kernel counts {counts}")
    return counts["K3"]


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
    if counts["K2"] <= 0 or counts["K1"] or counts["K3"] \
            or not no_plain_calls(counts):
        raise AssertionError(f"kernel counts {counts}")
    return counts["K2"]


# Mean GMRES iterations per step of the JAX package on a TPU v5e with the
# same 'auto' tier (benchlogs/transient_scaling.txt, 12-step means):
# a comparison band only, 0.5x-2x.
SCHUR_REF_LIN = {8: 54.5, 9: 72.2, 10: 89.5}
# The port's own mean GMRES per step at the defaults (Stokes + 3 / 2 / 1
# steps), the same in every run since the tier was ported: K1's routes
# sum in one order, so a change of route changes no bit.
SCHUR_PORT_LIN = {8: 46.0, 9: 55.0, 10: 66.0}


def schur_path_phase(matrix_id: int, n_steps: int, argv=(),
                     lin_band=None, time_forms: bool = True) -> tuple:
    """`run.main --matrix-id N` at its f32 defaults ('auto' -> the Schur
    tier): prep 'sch', every apply through K1 (no plain call), Newton <= 3,
    mean GMRES per step within 0.5x-2x of the JAX package's (or within
    `lin_band`) and, with no extra flags, equal to the port's own
    (SCHUR_PORT_LIN), every K1 form on the tiled route, peak device
    memory; then, with `time_forms`, each K1 form of the run's own prep
    checked and timed, both routes in turns from matrix 9 up.  Returns
    (counts, mean GMRES per step, GMRES iterations of the run, {form:
    k1_form's result})."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    extra = " " + " ".join(argv) if argv else ""
    out, counts = drive(f"Schur tier: run.main --matrix-id {matrix_id}{extra}"
                        f", float32 defaults, Stokes + {n_steps} steps "
                        "('sch')", ["--matrix-id", str(matrix_id), *argv],
                        n_steps)
    peak = torch.cuda.max_memory_allocated()
    solver = out.solver
    kr = solver.cfg.krylov
    lin = mean_lin(out)
    ref = SCHUR_REF_LIN[matrix_id]
    lo, hi = lin_band or (0.5 * ref, 2.0 * ref)
    print(f"matrix {matrix_id}: {4 * solver.disc.nv} rows; preconditioner "
          f"{kr.preconditioner}, schur_cheby {kr.schur_cheby}, schur_v_cheby "
          f"{kr.schur_v_cheby}, shape {kr.schur_shape}, coarse_agg "
          f"{kr.coarse_agg}, cgs2 {kr.cgs2}; mean GMRES per step {lin:.1f} "
          f"(band {lo:.1f}-{hi:.1f}; JAX package on TPU v5e: {ref}); peak "
          f"device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    print("host clock of the Newton operator's 'sch' prep (s): "
          + ", ".join(f"{k} {v:.3f}"
                      for k, v in solver._exact_prep.seconds.items()))
    if solver.prep_kind != "sch" or kr.preconditioner != "schur":
        raise AssertionError(f"prep {solver.prep_kind}, {kr}")
    if not lo <= lin <= hi:
        raise AssertionError(f"mean GMRES/step {lin} outside {lo}-{hi}")
    if not argv and lin != SCHUR_PORT_LIN[matrix_id]:
        raise AssertionError(f"mean GMRES/step {lin}, the port's own is "
                             f"{SCHUR_PORT_LIN[matrix_id]}")
    if counts["K1"] <= 0 or counts["K2"] or not no_plain_calls(counts):
        raise AssertionError(f"kernel counts {counts}")
    not_tiled = [f for f in counts["K1 forms"] if f[2] != "tiled"]
    if not_tiled or counts["K1 rows"]:
        raise AssertionError(f"K1 forms off the tiled route: {not_tiled}")
    gmres = solver.stokes_result.iters + sum(
        st.lin_iters for _, st, _ in solver.history)
    if not time_forms:
        return counts, lin, gmres, {}
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=solver.device)
    rng = np.random.default_rng(2031 + matrix_id)
    prep = solver._exact_prep
    timed = {form: k1_form(f"K1 m{matrix_id} run's {form} float32", offs,
                           planes, n_in, prep.nb, flush, rng,
                           routes=matrix_id >= 9)
             for form, (offs, planes, n_in) in schur_forms(prep).items()}
    return counts, lin, gmres, timed


def schur_cgs2_phase(lin_xla: float) -> int:
    """Matrix 8 with `--cgs2 pallas`: K3 on the tier's GMRES path, where
    V[:k+1] overflows shared memory; one launch per GMRES iteration."""
    counts, _, gmres, _ = schur_path_phase(
        8, 2, ["--cgs2", "pallas"], (0.8 * lin_xla, 1.25 * lin_xla),
        time_forms=False)
    print(f"K3 launches {counts['K3']} for {gmres} GMRES iterations "
          f"(Stokes + steps): {counts['K3'] / gmres:.3f} per iteration")
    if not gmres <= counts["K3"] <= 1.05 * gmres:
        raise AssertionError(f"{counts['K3']} K3 launches for {gmres} GMRES "
                             "iterations")
    return counts["K3"]


def bf16_path_phase(kind: str) -> tuple:
    """matvec_dtype='bfloat16' at matrix 6 in float32 on 'tl' (two_level,
    spmv='pallas', Chebyshev 3) or 'bj' (block_jacobi), with the JAX
    package's test tolerances (Krylov rtol 1e-4 / atol 1e-5, Newton rtol
    1e-3 / atol 1e-4; 'bj' with Neumann order 2, the CLI's, since with the
    test's order 1 its full-precision GMRES solves stop at maxiter at this
    size), beside the same config in full precision, built through
    NavierStokesSolver (the CLI has no flag for it).  The bf16 run's own
    Stokes solve (on the bf16 operator, as in the JAX package) and 3 steps
    from it must converge; their drift from the full-precision state is
    printed ('bj''s Stokes solve stops at maxiter at this size, in the JAX
    package too).  As in the JAX package's `test_bf16_matvec_mode`, 3 bf16
    steps from the full-precision Stokes state must converge, and on 'tl'
    land within rel 5e-2 of the full-precision steps (Newton's residual is
    taken with the full-precision operator).  On 'bj' that drift is
    printed only: the bf16 S perturbs a system this ill-conditioned past
    what Newton's full-precision residual corrects, in the JAX package as
    in the port (tests/test_torch_model.py::
    test_matvec_dtype_block_jacobi_drifts_as_in_jax).  The bf16 K2 form
    runs and no plain version.  Returns (bf16 K2 launches, counts)."""
    extra = dict(preconditioner="two_level", spmv="pallas", coarse_cheby=3,
                 neumann_order=1) if kind == "tl" else dict(
                     preconditioner="block_jacobi", neumann_order=2)
    kr = SolverConfig(rtol=1e-4, atol=1e-5, maxiter=3000, **extra)
    newton = NewtonConfig(rtol=1e-3, atol=1e-4, du_tol=float("inf"))
    phase(f"matvec_dtype='bfloat16' on the float32 '{kind}' path at matrix "
          "6, Stokes + 3 steps, beside full precision")
    mesh = scaling_series_mesh(6)
    disc = None
    solvers = {}
    for mv in (None, "bfloat16"):
        cfg = NSConfig(dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
                       krylov=dataclasses.replace(kr, matvec_dtype=mv),
                       stokes_krylov=dataclasses.replace(kr, matvec_dtype=mv),
                       newton=newton)
        solvers[mv] = NavierStokesSolver(mesh, cfg, disc=disc,
                                         device="cuda")
        disc = solvers[mv].disc

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    def trajectory(mv, u0, label):
        """3 steps from u0, counted alone: (state, counts)."""
        solver = solvers[mv]
        solver.history.clear()
        reset_counters()
        u = solver.run(3, u0=u0, monitor=False)
        torch.cuda.synchronize()
        counts = counters()
        hist = solver.history
        step_ms = 1e3 * sum(sec for _, _, sec in hist) / len(hist)
        print(f"matvec_dtype={mv}, {label}: steps (newton, gmres) "
              + " ".join(f"({st.iters}, {st.lin_iters})"
                         for _, st, _ in hist)
              + f"; mean step {step_ms:.2f} ms; kernel counts {counts}",
              flush=True)
        if not all(st.converged for _, st, _ in hist) \
                or not no_plain_calls(counts) or counts["K2"] <= 0 \
                or not bool(torch.isfinite(u).all()):
            raise AssertionError(f"matvec_dtype={mv} on '{kind}', {label}: "
                                 f"a step did not converge, or counts "
                                 f"{counts}")
        return u, counts

    stokes = {}
    for mv, solver in solvers.items():
        if solver.prep_kind != kind:
            raise AssertionError(f"prep {solver.prep_kind}")
        reset_counters()
        stokes[mv] = solver.stokes_init()
        solver._ensure_prepared()
        torch.cuda.synchronize()
        res = solver.stokes_result
        print(f"matvec_dtype={mv}: prep {solver.prep_kind}, Stokes gmres="
              f"{res.iters} converged={res.converged}; K2 forms "
              f"{counters()['K2 forms']}")
        # Block-Jacobi's Stokes solve stops at maxiter at this size in the
        # JAX package too (ROADMAP, reference faults); the steps converge
        if kind == "tl" and not res.converged:
            raise AssertionError(f"matvec_dtype={mv}: Stokes did not "
                                 "converge")
    u0 = stokes[None]
    v16, v32 = (stokes[m].reshape(-1, 4) for m in ("bfloat16", None))
    print(f"the bf16 operator's own Stokes state against full precision: "
          f"rel {rel(stokes['bfloat16'], u0):.3e} (velocity "
          f"{rel(v16[:, :3], v32[:, :3]):.3e}, pressure "
          f"{rel(v16[:, 3], v32[:, 3]):.3e}); no bar: it solves the "
          "bf16-rounded Stokes system, which no Newton step corrects")
    u32, _ = trajectory(None, u0, "from its Stokes state")
    u16, counts = trajectory("bfloat16", u0, "from the full-precision "
                             "Stokes state")
    drift = rel(u16, u32)
    own, _ = trajectory("bfloat16", stokes["bfloat16"], "from its own "
                        "Stokes state")
    bf16 = counts["K2 forms"].get("bfloat16/float32", 0)
    print(f"'{kind}' bf16 steps against full precision, 3 steps from one "
          f"Stokes state: rel {drift:.3e} "
          + ("(bar 5e-2)" if kind == "tl" else "(printed only)")
          + "; from its own Stokes "
          f"state: rel {rel(own, u32):.3e} (printed only); bf16 K2 launches "
          f"in 3 steps {bf16}")
    if bf16 <= 0:
        raise AssertionError(f"bf16 K2 launches {counts}")
    if kind == "tl" and not drift < 5e-2:
        raise AssertionError(f"bf16 state drift {drift}")
    return bf16, counts


def quiet_main(argv: list):
    """run.main with its output captured and echoed; returns (RunOutput,
    the output text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = run.main(argv + ["--device", CLI_DEVICE])
    text = buf.getvalue()
    print(text, end="", flush=True)
    return out, text


def msh_phase() -> None:
    """`--msh` on the matrix-6 mesh written by the port's write_gmsh:
    Stokes + 2 steps at the f32 defaults, converged, the physics checks."""
    phase("CLI I/O: write_gmsh of the matrix-6 mesh")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m6.msh")
        t0 = time.perf_counter()
        write_gmsh(scaling_series_mesh(6), path)
        print(f"write_gmsh of the matrix-6 mesh: "
              f"{os.path.getsize(path)} bytes in "
              f"{time.perf_counter() - t0:.3f} s")
        out, counts = drive("CLI I/O: run.main --msh (the matrix-6 mesh "
                            "through write_gmsh), float32, Stokes + 2 steps",
                            ["--msh", path, "--dtype", "float32"], 2)
    if out.solver.prep_kind != "tlp" or counts["K1"] <= 0:
        raise AssertionError(f"prep {out.solver.prep_kind}, {counts}")


def cli_io_phase() -> None:
    """`--save --vtu`, `--checkpoint --checkpoint-every 2` and `--profile`
    in one 2-step run at matrix 6 (f32); then `--resume` to step 4, whose
    `solution_step0004.dat` must equal an uninterrupted 4-step run's bit
    for bit."""
    phase("CLI I/O at matrix 6: --save --vtu --checkpoint --checkpoint-every "
          "2 --profile (2 steps), --resume to step 4, and 4 steps "
          "uninterrupted")
    base = ["--matrix-id", "6", "--dtype", "float32", "--save"]
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        dirs = {k: os.path.join(tmp, k) for k in ("a", "b", "c")}
        t0 = time.perf_counter()
        out_a, text = quiet_main(base + ["--steps", "2", "--save-dir",
                                         dirs["a"], "--vtu", "--checkpoint",
                                         ck, "--checkpoint-every", "2",
                                         "--profile"])
        print(f"run with --vtu, --checkpoint and --profile: "
              f"{time.perf_counter() - t0:.3f} s")
        files = sorted(os.listdir(dirs["a"]))
        want = ["solution_0001.vtu", "solution_0002.vtu",
                "solution_step0001.dat", "solution_step0002.dat",
                "time_series.pvd"]
        with open(os.path.join(dirs["a"], "solution_0002.vtu")) as f:
            vtu_head = f.read(200)
        if files != want or "UnstructuredGrid" not in vtu_head \
                or not os.path.exists(ck):
            raise AssertionError(f"--vtu/--checkpoint wrote {files}")
        for event in ("Event", "setup", "stokes_init", "operator_prep",
                      "time_loop"):
            if event not in text:
                raise AssertionError(f"--profile table lacks {event!r}")
        out_b, text_b = quiet_main(base + ["--steps", "4", "--save-dir",
                                           dirs["b"], "--resume", ck])
        out_c, _ = quiet_main(base + ["--steps", "4", "--save-dir",
                                      dirs["c"]])
        if "resumed from step 2" not in text_b or \
                [h[0] for h in out_b.solver.history] != [3, 4]:
            raise AssertionError("the resume did not go on from step 2")
        dat = "solution_step0004.dat"
        with open(os.path.join(dirs["b"], dat), "rb") as fb, \
                open(os.path.join(dirs["c"], dat), "rb") as fc:
            same_dat = fb.read() == fc.read()
        same_u = torch.equal(out_b.u, out_c.u)
        rel = float(np.linalg.norm(
            read_petsc_vec(os.path.join(dirs["b"], dat))
            - read_petsc_vec(os.path.join(dirs["c"], dat))))
        print(f"resumed step 4 against uninterrupted: .dat equal bit for "
              f"bit {same_dat}, state equal bit for bit {same_u} "
              f"(|diff| {rel:.3e})")
        if not (same_dat and same_u):
            raise AssertionError("the resumed run differs from the "
                                 "uninterrupted one")
    for out in (out_a, out_b, out_c):
        if not all(st.converged for _, st, _ in out.solver.history):
            raise AssertionError("a step did not converge")
        check_physics(out)


def disc_cache_phase() -> None:
    """`transient_bench --disc-cache` at matrix 8 twice: the first run
    builds and saves the discretization, the second loads it and repeats
    the first's counts and final state bit for bit."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--matrix-id", "8", "--preconditioner", "auto", "--steps",
                "1", "--disc-cache", os.path.join(tmp, "m8")]
        phase("discretization cache: transient_bench.main("
              + " ".join(argv[:-1]) + " <dir>) twice")
        res = []
        for _ in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stderr(buf):
                res += transient_bench.main(argv)
            print(buf.getvalue(), end="", flush=True)
            if len(res) == 1:
                size = sum(os.path.getsize(os.path.join(tmp, "m8", f))
                           for f in os.listdir(os.path.join(tmp, "m8")))
                print(f"cache: {size} bytes")
    built, loaded = res
    print(f"discretization: built and saved in {built['disc_s']:.3f} s, "
          f"loaded in {loaded['disc_s']:.3f} s; solver setup "
          f"{built['setup_s']:.3f} s / {loaded['setup_s']:.3f} s")
    same = torch.equal(built["state"], loaded["state"])
    counts = [(r["newton"], r["lin"], r["mean_lin"]) for r in res]
    print(f"counts (newton, lin, mean lin) {counts}; final state equal bit "
          f"for bit {same}")
    if counts[0] != counts[1] or not same:
        raise AssertionError("the run from the cache differs")


def golden_phase(dev):
    phase("small-input reference: golden trajectory, float64 on the card")
    golden = np.asarray(load_golden())
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

    flagship = dict(preconditioner="auto", spmv="plane")
    schur = dict(preconditioner="schur", spmv="plane", schur_v_cheby=2)
    for mode, kw, bar in (
            ("flagship mode", flagship, 1e-7),
            ("flagship mode, cgs2='pallas' (K3)", dict(flagship,
                                                       cgs2="pallas"), 1e-7),
            ("the Schur tier forced", schur, 1e-7),
            ("block-Jacobi path", {}, GOLDEN_BJ_BAR)):
        reset_counters()
        kind, states = trajectory(kw)
        k3_launches = k3_ops.kernel_launches
        if (k3_launches > 0) != (kw.get("cgs2") == "pallas") \
                or not no_plain_calls(counters()):
            raise AssertionError(f"golden {mode}: counts {counters()}")
        errs = [np.linalg.norm(u - g) / np.linalg.norm(g)
                for u, g in zip(states, golden)]
        print(f"golden rel errors, {mode} ({kind}; Stokes, steps 1-5): "
              + " ".join(f"{e:.3e}" for e in errs) + f" (bar {bar:.3e}); "
              f"K3 launches {k3_launches}")
        if max(errs) > bar:
            raise AssertionError(f"golden trajectory ({mode}) off by "
                                 f"{max(errs):.3e}")
        # assembly adds in a fixed order: a second run repeats bit for bit
        if not np.array_equal(trajectory(kw)[1], states):
            raise AssertionError(f"golden trajectory ({mode}) differs "
                                 "between two runs")
    print("golden trajectories repeat bit for bit in a second run")


def bench_phase():
    argv = ["--matrices", "6", "--kernel", "spm2v,spm3v,spm4v"]
    phase("benchmark entry point: bench.spmv_bench.main(" + " ".join(argv)
          + ")")
    reset_counters()
    rows = spmv_bench.main(argv)
    counts = counters()
    print(f"kernel counts on this path: {counts}")
    fused = [r for r in rows if "FUSED" in r["name"]]
    if len(fused) != 3 or any(not r["rel_err"] <= 1e-5 for r in fused):
        raise AssertionError(f"fused K4 variants: {fused}")
    if counts["K4"] <= 0 or counts["K2"] <= 0 or counts["K1"] <= 0:
        raise AssertionError(f"kernel counts {counts}")
    return counts["K4"]


def bench_tools_phase():
    """The two bench tools of the tier on the card at matrix 8: their lines
    present, their numbers finite, every apply through K1."""
    tb_argv = ["--matrix-id", "8", "--preconditioner", "auto", "--steps", "3"]
    # gmres_decomp's defaults are the JAX tool's ('tl'): the tier is opt-in
    gd_argv = ["--matrix-id", "8", "--preconditioner", "auto",
               "--skip-slope", "--cgs2", "pallas"]
    phase("bench tools: transient_bench.main(" + " ".join(tb_argv)
          + ") and gmres_decomp.main(" + " ".join(gd_argv) + ")")
    reset_counters()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = transient_bench.main(tb_argv)
    text = buf.getvalue()
    print(text, end="", flush=True)
    lines = [ln for ln in text.splitlines() if ln.startswith("TRANSIENT ")]
    r = res[0] if res else {}
    if len(lines) != 1 or "prep=sch" not in lines[0] or not all(
            np.isfinite(r.get(k, np.nan)) for k in
            ("setup_s", "stokes_s", "compile_s", "step_ms", "mean_lin")):
        raise AssertionError(f"transient_bench: {lines}, {res}")
    counts = counters()
    print(f"kernel counts in transient_bench: {counts}")
    if counts["K1"] <= 0 or not no_plain_calls(counts):
        raise AssertionError(f"kernel counts {counts}")
    reset_counters()
    rows = gmres_decomp.main(gd_argv)
    counts = counters()
    print(f"kernel counts in gmres_decomp: {counts}")
    parts = ("apply_A", "apply_F", "apply_S", "fhat", "shat", "minv",
             "matvec = minv(A x)")
    if not all(np.isfinite(rows.get(p, np.nan)) and rows[p] > 0
               for p in parts) or counts["K1"] <= 0 or counts["K3"] <= 0 \
            or not no_plain_calls(counts):
        raise AssertionError(f"gmres_decomp: {rows}, {counts}")


# --- the solver options of ROADMAP slices 2/5, 10, 11, 12, 13 -------------

def f32_flagship_cfg(**changes) -> NSConfig:
    """The CLI's float32 config at matrix 6 (run.py), with `changes` on
    NSConfig and, under the key "krylov", on both Krylov configs."""
    kr = dataclasses.replace(run.default_f32_krylov(),
                             **changes.pop("krylov", {}))
    cfg = NSConfig(dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
                   newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                                       du_tol=float("inf")),
                   krylov=kr, stokes_krylov=kr)
    return dataclasses.replace(cfg, **changes)


def step_lines(label: str, hist) -> None:
    """Newton and GMRES per step, its ms, and in reference mode each Newton
    iteration's assembly / preparation / solve seconds."""
    for step, st, sec in hist:
        print(f"{label} step {step}: newton={st.iters} gmres={st.lin_iters} "
              f"converged={st.converged} {sec * 1e3:.1f} ms")
        for i, (a, p, s) in enumerate(st.seconds):
            print(f"    Newton iteration {i + 1}: assembly {a:.4f} s, prep "
                  f"(host coarse inverse) {p:.4f} s, solve {s:.4f} s")


def forms_text(forms: dict) -> dict:
    """Launches by form with the form as text: "n_out x n_in/offsets/route"
    for K1, "data/x dtype" for K2."""
    return {k if isinstance(k, str) else "/".join(map(str, k)): v
            for k, v in forms.items()}


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a.double() - b.double())
                 / torch.linalg.norm(b.double()))


def reference_mode_phase(dev, matrix_id: int = 6) -> dict:
    """(a) jacobian='reference', residual='reference' (element-wise), float32
    at matrix 6 through the solver API on 'tlp' ('auto' resolves to plain
    two_level there): Stokes + 2 steps, each converged within the config's
    max_iter of 30 Newton iterations, every apply through K1 and no plain
    call; the gap to the exact-Jacobian steps from the same Stokes state;
    then one float64 residual evaluation, element-wise against the operator
    form (K2), at rel <= 1e-12."""
    phase(f"(a) reference Jacobian, element-wise residual: matrix "
          f"{matrix_id}, float32, 'tlp', Stokes + 2 steps (solver API)")
    mesh = scaling_series_mesh(matrix_id)
    ref = NavierStokesSolver(mesh, f32_flagship_cfg(
        jacobian="reference", residual="reference"), device=dev)
    kr = ref.cfg.krylov
    if ref.prep_kind != "tlp" or kr.preconditioner != "two_level" \
            or kr.coarse_cheby:
        raise AssertionError(f"prep {ref.prep_kind}, {kr}")
    t0 = time.perf_counter()
    u0 = ref.stokes_init()
    _sync(dev)
    print(f"Stokes: gmres={ref.stokes_result.iters} converged="
          f"{ref.stokes_result.converged} {time.perf_counter() - t0:.3f} s")
    reset_counters()
    u_ref = ref.run(2, u0=u0, monitor=False)
    counts = counters()
    step_lines("reference", ref.history)
    print(f"kernel counts, 2 reference-mode steps: {counts}")
    if not all(st.converged for _, st, _ in ref.history) \
            or counts["K1"] <= 0 or not no_plain_calls(counts):
        raise AssertionError(f"reference mode: {counts}")
    exact = NavierStokesSolver(mesh, f32_flagship_cfg(krylov=dict(
        preconditioner="two_level")), disc=ref.disc, device=dev)
    u_ex = exact.run(2, u0=u0, monitor=False)
    step_lines("exact", exact.history)
    gap = rel_gap(u_ref, u_ex)
    print(f"reference against exact Jacobian after 2 steps from one Stokes "
          f"state: rel {gap:.3e} (printed only: both stop at Newton rtol "
          "1e-4)")

    disc = build_discretization(mesh, torch.float64, dev)
    pat = disc.dia_pattern
    rng = np.random.default_rng(2026)
    u, u_old = (torch.as_tensor(rng.standard_normal(disc.ndof), device=dev)
                for _ in range(2))

    def assemble(terms):
        return assemble_dia_values(disc.vol, disc.grad, disc.h, 1e-3, 300.0,
                                   0.05, disc.dia_elem_map, terms=terms,
                                   K=pat.K, ndof=disc.ndof)
    jlin, mass = assemble(LINEAR_TERMS), assemble(frozenset({"mass_dt_bare"}))
    reset_counters()
    f_op = dia_ops.spmv_dia(pat.offsets, jlin, u) \
        - dia_ops.spmv_dia(pat.offsets, mass, u_old)
    f_el = assemble_residual(disc.tets, disc.vol, disc.grad, disc.h, u, u_old,
                             1e-3, 300.0, 0.05, ndof=disc.ndof)
    rel = rel_gap(f_el, f_op)
    print(f"float64 residual at a seeded random state: element-wise against "
          f"operator form (K2 {counters()['K2 forms']}) rel {rel:.3e} (bar "
          "1e-12)")
    if not rel <= 1e-12:
        raise AssertionError(f"residual forms differ: {rel}")
    return {"K1 per step": counts["K1"] / 2,
            "K1 forms": forms_text(counts["K1 forms"]), "gap": gap}


def golden_reference_phase(dev) -> dict:
    """(b) the golden trajectory in the golden corpus's own mode (reference
    Jacobian, element-wise residual, block-Jacobi 'bj', K2), float64 on the
    card at 1e-8, twice: the second run repeats the first bit for bit."""
    phase("(b) golden trajectory in reference mode, float64 on the card "
          "('bj', K2)")
    golden = np.asarray(load_golden())
    kr = SolverConfig(rtol=1e-13, atol=1e-14, maxiter=4000)
    cfg = NSConfig(dt=1e-3, t_final=5e-3, reynolds=100.0, delta=0.1,
                   dtype="float64", jacobian="reference",
                   residual="reference", krylov=kr, stokes_krylov=kr,
                   newton=NewtonConfig(rtol=1e-6, atol=1e-8, stol=1e-10,
                                       max_iter=30))
    runs = []
    for _ in range(2):
        reset_counters()
        solver = NavierStokesSolver(channel_mesh(4, 2, 2), cfg, device=dev)
        states = [solver.stokes_init()]
        du, lin = torch.zeros_like(states[0]), []
        for _ in range(5):
            u, du, st = solver.step(states[-1], states[-1], du)
            if not st.converged:
                raise AssertionError("golden reference-mode step did not "
                                     "converge")
            lin.append((st.iters, st.lin_iters))
            states.append(u)
        runs.append(torch.stack(states).cpu().numpy())
        counts = counters()
    errs = [np.linalg.norm(u - g) / np.linalg.norm(g)
            for u, g in zip(runs[0], golden)]
    print(f"golden rel errors, reference mode ({solver.prep_kind}; Stokes, "
          "steps 1-5): " + " ".join(f"{e:.3e}" for e in errs)
          + f" (bar 1e-8); (newton, gmres) per step {lin}; kernel counts "
          f"{counts}")
    if solver.prep_kind != "bj" or max(errs) > 1e-8 or counts["K2"] <= 0 \
            or not no_plain_calls(counts):
        raise AssertionError(f"golden reference mode: {max(errs)}, {counts}")
    if not np.array_equal(runs[0], runs[1]):
        raise AssertionError("golden reference mode differs between runs")
    print("repeats bit for bit in a second run")
    return {"K2 in 5 steps": counts["K2"], "max err": max(errs)}


def load_golden():
    spec = importlib.util.spec_from_file_location(
        "data_golden_trajectory",
        os.path.join(ROOT, "tests", "data_golden_trajectory.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.TRAJ


def linear_coarse_phase(matrix_id: int = 6, agg: int = 128) -> dict:
    """(c) the linear coarse basis on 'tlp' through the CLI: matrix 6,
    --coarse-agg 128 (nc = 16 x 230 = 3,680), 3 steps, K1 for every apply;
    mean GMRES beside the JAX package's 57.5-60.1 (TPU v5e, history)."""
    out, counts = drive(f"(c) linear coarse basis: run.main --matrix-id "
                        f"{matrix_id} --preconditioner two_level "
                        f"--coarse-basis linear --coarse-agg {agg}, float32, "
                        "Stokes + 3 steps ('tlp')",
                        ["--matrix-id", str(matrix_id), "--dtype", "float32",
                         "--preconditioner", "two_level", "--coarse-basis",
                         "linear", "--coarse-agg", str(agg)], 3)
    solver = out.solver
    nc = solver._exact_prep.coarse.ac_inv.shape[0]
    lin = mean_lin(out)
    print(f"linear basis nc = {nc}; mean GMRES per step {lin:.1f} (JAX "
          "package at matrix 6, 57.5-60.1, TPU v5e, history: "
          "benchlogs/transient_scaling.txt)")
    if solver.prep_kind != "tlp" or solver.cfg.krylov.coarse_basis \
            != "linear" or counts["K1"] <= 0 or not no_plain_calls(counts):
        raise AssertionError(f"prep {solver.prep_kind}, {counts}")
    return {"K1": counts["K1"], "K1 forms": forms_text(counts["K1 forms"]),
            "mean GMRES": lin, "nc": nc}


def sa_phase(dev, matrix_id: int = 3, big: int = 6) -> dict:
    """(d) smoothed aggregation, omega 0.6667: at matrix 3 in float64 on
    'tlp' (coarse_agg 48, nc = 124), Stokes + 2 steps on the card and
    through the port on the CPU: Newton counts equal, GMRES counts within
    1 per solve (K1 and its plain version sum in another order, and a
    solve that ends at its tolerance may take one iteration more or
    less), states at rel <= 1e-9 (the JAX package's history beside them);
    then at matrix 6 the SA prep is built and timed only (the JAX
    package's SA stagnates there)."""
    argv = ["--matrix-id", str(matrix_id), "--dtype", "float64",
            "--preconditioner", "two_level", "--spmv", "plane",
            "--coarse-agg", "48", "--coarse-smooth-omega", "0.6667"]
    out, counts = drive("(d) smoothed aggregation: run.main "
                        + " ".join(argv) + ", Stokes + 2 steps", argv, 2,
                        max_newton=None, stokes_must_converge=False)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = run.main(argv + ["--steps", "2", "--device", "cpu"])
    cpu_s = time.perf_counter() - t0

    def summary(o):
        return [o.solver.stokes_result.iters] + [
            (st.iters, st.lin_iters) for _, st, _ in o.solver.history]
    card, host = summary(out), summary(cpu)
    rel = rel_gap(out.u.cpu(), cpu.u)
    same = abs(card[0] - host[0]) <= 1 and all(
        nc == nh and abs(gc - gh) <= nc - 1
        for (nc, gc), (nh, gh) in zip(card[1:], host[1:]))
    print(f"SA matrix {matrix_id} (Stokes gmres, then (newton, gmres) per "
          f"step): card {card}, CPU {host} ({cpu_s:.1f} s); states rel "
          f"{rel:.3e} (bar 1e-9); JAX package, f64 on the CPU (history, "
          "benchlogs/transient_scaling.txt): Newton 3 / GMRES 195, then "
          "Newton 2 / GMRES 90")
    if out.solver.prep_kind != "tlp" or not same or not rel <= 1e-9 \
            or counts["K1"] <= 0 or not no_plain_calls(counts):
        raise AssertionError(f"SA: card {card}, CPU {host}, rel {rel}, "
                             f"{counts}")
    phase(f"(d) smoothed-aggregation prep at matrix {big}, float32 'tlp' "
          "(built and timed only)")
    mesh = scaling_series_mesh(big)
    solver = NavierStokesSolver(mesh, f32_flagship_cfg(krylov=dict(
        preconditioner="two_level", coarse_smooth_omega=0.6667)), device=dev)
    offs = solver.disc.dia_pattern.offsets
    jlin = solver._assemble_dia(LINEAR_TERMS, solver.cfg.reynolds)
    jlin = zero_rows_dia(offs, jlin, solver.disc.bc.is_bc)
    _sync(dev)
    t0 = time.perf_counter()
    prep = solver._prepare_operator_dia(jlin)
    _sync(dev)
    sa_s = time.perf_counter() - t0
    print(f"SA prep at matrix {big}: {sa_s:.3f} s (nc = "
          f"{prep.coarse.ac_inv.shape[0]}, Chebyshev degree "
          f"{prep.cheby[2] if prep.cheby else 0})")
    return {"K1": counts["K1"], "card": card, "prep s": sa_s}


def ca_gmres_phase(dev, matrix_id: int = 6) -> dict:
    """(e) CA-GMRES through the CLI with the Newton basis, restart 12, at
    matrix 6 in float32: 2 steps, converged (the Stokes solve runs before
    the shifts exist and is monomial, as in the JAX package: not required
    to converge); then the monomial basis through the solver API, one
    Newton iteration capped at 300 GMRES, reported only (the JAX package's
    monomial basis stalls in float32 here)."""
    out, counts = drive(f"(e) CA-GMRES: run.main --matrix-id {matrix_id} "
                        "--ca-gmres --ca-basis newton --restart 12, float32, "
                        "Stokes + 2 steps", ["--matrix-id", str(matrix_id),
                                             "--dtype", "float32",
                                             "--ca-gmres", "--ca-basis",
                                             "newton", "--restart", "12"], 2,
                        stokes_must_converge=False)
    solver = out.solver
    print(f"Newton-basis shifts (Leja order): "
          + ", ".join(f"{t:.4g}" for t in solver._ca_shifts))
    if solver.cfg.krylov.method != "ca_gmres" or counts["K1"] <= 0 \
            or not no_plain_calls(counts):
        raise AssertionError(f"{solver.cfg.krylov}, {counts}")
    mono = NavierStokesSolver(
        solver.disc.mesh, f32_flagship_cfg(
            krylov=dict(method="ca_gmres", restart=12, maxiter=300),
            newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                                du_tol=float("inf"), max_iter=1)),
        disc=solver.disc, device=dev)
    reset_counters()
    t0 = time.perf_counter()
    _, _, st = mono.step(out.u, out.u, torch.zeros_like(out.u))
    _sync(dev)
    mono_counts = counters()
    print(f"monomial basis, one Newton iteration capped at 300 GMRES: "
          f"gmres={st.lin_iters} from |F| {st.res_hist[0]:.3e}, "
          f"converged={st.converged} ({time.perf_counter() - t0:.3f} s; "
          f"reported only); kernel counts {mono_counts}")
    if not no_plain_calls(mono_counts):
        raise AssertionError(f"monomial: {mono_counts}")
    return {"K1": counts["K1"], "mean GMRES": mean_lin(out),
            "Stokes GMRES": solver.stokes_result.iters,
            "monomial GMRES": st.lin_iters}


def deflation_phase(matrix_id: int = 6, k: int = 16) -> dict:
    """(f) deflation through the CLI at matrix 6 in float32, --deflation-k
    16: 2 steps; again with --cgs2 pallas, where every GMRES iteration of
    the deflated solves launches K3 once (the Arnoldi of the setup runs
    GEMVs): K3 launches equal the GMRES iterations of the run (Stokes +
    steps) and of each of two further steps, counted alone."""
    res = {}
    for cgs2 in ("xla", "pallas"):
        argv = ["--matrix-id", str(matrix_id), "--dtype", "float32",
                "--deflation-k", str(k), "--cgs2", cgs2]
        out, counts = drive(f"(f) deflation: run.main {' '.join(argv)}, "
                            "float32, Stokes + 2 steps", argv, 2)
        solver = out.solver
        prep = solver._exact_prep
        qq = float((prep.Q @ prep.Q.T - torch.eye(
            prep.Q.shape[0], dtype=prep.Q.dtype, device=prep.Q.device)
                    ).abs().max())
        print(f"recycled pair: k = {prep.Q.shape[0]}, max |Q Q^T - I| "
              f"{qq:.3e}")
        if prep.kind != "defl" or counts["K1"] <= 0 \
                or not no_plain_calls(counts) or not qq <= 1e-4:
            raise AssertionError(f"deflation: {prep.kind}, {counts}, {qq}")
        res[cgs2] = {"mean GMRES": mean_lin(out), "K1": counts["K1"]}
        if cgs2 == "xla":
            continue
        gmres_its = solver.stokes_result.iters + sum(
            st.lin_iters for _, st, _ in solver.history)
        per_step = []
        u = out.u
        for _ in range(2):
            reset_counters()
            u, _, st = solver.step(u, u, torch.zeros_like(u))
            per_step.append((st.lin_iters, counters()["K3"]))
        print(f"K3 launches {counts['K3']} for {gmres_its} GMRES iterations "
              f"(Stokes + steps); two further steps (GMRES, K3): "
              f"{per_step}")
        if not gmres_its <= counts["K3"] <= 1.05 * gmres_its or any(
                not g <= n <= 1.05 * g + 1 for g, n in per_step):
            raise AssertionError(f"K3 launches {counts['K3']} for "
                                 f"{gmres_its}; {per_step}")
        res[cgs2]["K3"] = counts["K3"]
        res[cgs2]["per step"] = per_step
    return res


def cg_ilu_phase(dev, matrix_id: int = 6, ilu_matrix: int = 3) -> dict:
    """(g) CG, float64, on the pressure-pressure plane of the matrix-6
    Stokes operator taken before the BC rows are zeroed (delta h^2 vol
    grad phi_i . grad phi_j, symmetric) plus 0.1 I, applied by K1's 1x1
    form: converged, x against the CPU solve (K1's plain version) at rel
    1e-9; then GMRES at matrix 3 with the ILU(0) host oracle against
    block-Jacobi, the matvec through K2: ILU takes no more iterations,
    the same x at 1e-6."""
    phase(f"(g) CG on the matrix-{matrix_id} pressure block (K1 1x1), and "
          f"ILU(0) against block-Jacobi at matrix {ilu_matrix} (K2)")
    disc = build_discretization(scaling_series_mesh(matrix_id),
                                torch.float64, dev)
    pat, nb = disc.dia_pattern, disc.nv
    stokes = assemble_dia_values(disc.vol, disc.grad, disc.h, 1e-3, 0.01,
                                 0.05, disc.dia_elem_map,
                                 terms=frozenset({"diffusion"}), K=pat.K,
                                 ndof=disc.ndof)
    noffs = pd.node_offsets_from_scalar(pat.offsets)
    nbp = pd.plane_nbp(nb)
    p4 = pd.extract_planes(pat.offsets, stokes, nb, node_offsets=noffs,
                           nbp=nbp)
    pp = p4[3:4, 3::4].contiguous()                  # (1, N_D, nbp)
    pp[0, noffs.index(0), :nb] += 0.1
    b = torch.zeros(nbp, dtype=torch.float64, device=dev)
    b[:nb] = torch.as_tensor(np.random.default_rng(5).standard_normal(nb),
                             device=dev)
    out = {}
    for where in ("card", "cpu"):
        planes, rhs = (pp, b) if where == "card" else (pp.cpu(), b.cpu())
        reset_counters()
        t0 = time.perf_counter()
        res = cg(lambda x: pd.spmv_planes(noffs, planes, x, n_in=1, nb=nb),
                 rhs, rtol=1e-12, atol=1e-14, maxiter=2000)
        out[where] = (res, time.perf_counter() - t0, counters())
    (rc, tc, cc), (rh, th, _) = out["card"], out["cpu"]
    rel = rel_gap(rc.x.cpu(), rh.x)
    forms = {f: n for f, n in cc["K1 forms"].items() if f[0] == "1x1"}
    print(f"CG: card {rc.iters} its converged={rc.converged} {tc:.3f} s, "
          f"CPU {rh.iters} its {th:.3f} s; x rel {rel:.3e} (bar 1e-9); K1 "
          f"1x1 launches {forms}")
    if not (rc.converged and rh.converged) or not rel <= 1e-9 \
            or not forms or not no_plain_calls(cc):
        raise AssertionError(f"CG: {rc.converged}, {rel}, {cc}")

    d3 = build_discretization(scaling_series_mesh(ilu_matrix), torch.float64,
                              dev)
    op = assemble_operator(d3, torch.zeros(d3.ndof, dtype=torch.float64,
                                           device=dev), 0.01, 50.0, 0.1,
                           LINEAR_TERMS)
    op.values = zero_rows_bcsr(op.values, d3.row_ids, d3.indices,
                               d3.diag_slots, d3.bc.row_bc)
    p3 = d3.dia_pattern
    a3 = assemble_dia_values(d3.vol, d3.grad, d3.h, 0.01, 50.0, 0.1,
                             d3.dia_elem_map, terms=LINEAR_TERMS, K=p3.K,
                             ndof=d3.ndof)
    a3 = zero_rows_dia(p3.offsets, a3, d3.bc.is_bc)
    rhs = d3.bc.value.to(torch.float64)

    def matvec(x):
        return dia_ops.spmv_dia(p3.offsets, a3, x)
    t0 = time.perf_counter()
    ilu = precond.ILU0Preconditioner(op)
    fact_s = time.perf_counter() - t0
    runs = {}
    for name, m in (("block-Jacobi", precond.BlockJacobiPreconditioner
                     .from_bcsr(op, d3.diag_slots)), ("ILU(0)", ilu)):
        reset_counters()
        t0 = time.perf_counter()
        r = gmres(matvec, rhs, precond=m, restart=30, rtol=1e-10, atol=1e-12)
        runs[name] = (r, time.perf_counter() - t0, counters())
    (rj, tj, cj), (ri, ti, ci) = runs["block-Jacobi"], runs["ILU(0)"]
    diff = float((ri.x - rj.x).abs().max())
    print(f"matrix {ilu_matrix} GMRES(30): block-Jacobi {rj.iters} its "
          f"{tj:.3f} s, ILU(0) {ri.iters} its {ti:.3f} s (factorization "
          f"{fact_s:.3f} s, host); max |x_ILU - x_BJ| {diff:.3e} (bar 1e-6); "
          f"K2 launches {cj['K2']} / {ci['K2']}")
    if not (rj.converged and ri.converged) or ri.iters > rj.iters \
            or not diff <= 1e-6 or not cj["K2"] or not ci["K2"] \
            or not no_plain_calls(ci) or not no_plain_calls(cj):
        raise AssertionError(f"ILU: {runs}")
    return {"CG its": rc.iters, "K1 1x1": sum(forms.values()),
            "ILU its": ri.iters, "BJ its": rj.iters}


# --- distribution (ROADMAP slice 15): phases (h)-(k) ------------------------

SHARDS = 4


def shard_csr(offsets, data, halo: int):
    """One shard's scalar-DIA rows (K, L) against its ghosted x window
    (L + 2 halo) as CSR: entry (i, halo + i + off)."""
    k, L = data.shape
    i = torch.arange(L, device=data.device)
    rows = torch.cat([i] * k)
    cols = torch.cat([i + halo + d for d in offsets])
    return csr_from_coo(rows, cols, data.reshape(-1), (L, L + 2 * halo))


def shard_plane_csr(noffs, planes, n_in: int, halo: int):
    """One shard's plane rows (n_out, n_in * N_D, Lb) against its ghosted
    plane-major x window (n_in * (Lb + 2 halo)) as CSR."""
    n_out, _, Lb = planes.shape
    w = Lb + 2 * halo
    i = torch.arange(Lb, device=planes.device)
    rows, cols, vals = [], [], []
    for a in range(n_out):
        for j, (b, d) in enumerate(pd.plane_terms(noffs, n_in)):
            rows.append(a * Lb + i)
            cols.append(b * w + halo + i + d)
            vals.append(planes[a, j])
    return csr_from_coo(torch.cat(rows), torch.cat(cols), torch.cat(vals),
                        (n_out * Lb, n_in * w))


def halo_k1_phase(dev, mesh, pat, data64, flush) -> dict:
    """(h), K1: matrix 6 cut into 4 and 8 shards, every shard's ghost-row
    launch against the rows of one launch on the whole vector (bit for bit,
    each route where both fit) and its plain version (within the bars of
    phase 3), also on random data with nonzero ghost rows; one interior
    shard timed beside its plain version, cuSPARSE on the shard's rows with
    their ghost columns, its bound and the whole-matrix launch."""
    noffs = pd.node_offsets_from_scalar(pat.offsets)
    nb, n_d = mesh.nv, len(noffs)
    sel3 = [iD * 4 + b for iD in range(n_d) for b in range(3)]
    rng = np.random.default_rng(2091)
    summary = {}
    for P, forms in ((4, (("4x4", torch.float32), ("4x4", torch.float64),
                          ("3x3", torch.float32))),
                     (8, (("4x4", torch.float32),))):
        for form, dtype in forms:
            n_in = int(form[0])
            bar = BARS[dtype]
            itemsize = torch.tensor([], dtype=dtype).element_size()
            Lb = tpart.plane_shard_nodes(nb, noffs, P, 48, itemsize)
            nbp = P * Lb
            p4 = pd.extract_planes(pat.offsets, data64, nb,
                                   node_offsets=noffs, nbp=nbp)
            planes = (p4 if n_in == 4 else p4[:3][:, sel3]).to(dtype)
            planes = planes.contiguous()
            g = pd.ghost_width(noffs, itemsize)
            x = torch.zeros((n_in, nbp), dtype=dtype, device=dev)
            x[:, :nb] = torch.as_tensor(rng.standard_normal((n_in, nb)),
                                        dtype=dtype, device=dev)
            shards = tpart.split_rows(planes, Lb, [dev] * P).parts
            windows = [w.reshape(-1).contiguous() for w in tpart.exchange(
                tpart.split_rows(x, Lb, [dev] * P).parts, g)]
            live = tpart.shard_rows(nb, Lb, P)
            label = f"K1 {form} {str(dtype)[6:]} with ghost rows, {P} shards"
            routes = [r for r in pd.ROUTES if r == "rows" or (
                pd.tiled_plan(noffs, planes, x.reshape(-1), n_in)
                and pd.tiled_plan(noffs, shards[1], windows[1], n_in,
                                  halo=g))]
            chosen = pd.plane_route(noffs, shards[1], windows[1], n_in,
                                    halo=g)
            errs = {}
            for route in routes:
                whole = pd.spmv_planes_cuda(noffs, planes, x.reshape(-1),
                                            n_in=n_in, nb=nb, route=route)
                got = torch.cat([pd.spmv_planes_cuda(
                    noffs, p, w, n_in=n_in, nb=n, route=route, halo=g
                ).reshape(-1, Lb) for p, w, n in zip(shards, windows, live)],
                    dim=1)
                if not torch.equal(got, whole.reshape(-1, nbp)):
                    raise AssertionError(f"{label} {route}: shard rows differ "
                                         "from the whole-vector launch")
                ref = torch.cat([pd.spmv_planes_plain(
                    noffs, p, w, n_in=n_in, nb=n, halo=g).reshape(-1, Lb)
                    for p, w, n in zip(shards, windows, live)], dim=1)
                rel = float(torch.linalg.norm(got - ref)
                            / torch.linalg.norm(ref))
                if rel > bar:
                    raise AssertionError(f"{label} {route}: rel {rel:.3e}")
                errs[route] = (rel, float((got - ref).abs().max()))
            # random data and ghost rows (nonzero everywhere)
            rp = torch.randn(shards[1].shape, dtype=dtype, device=dev)
            rw = torch.randn(windows[1].shape, dtype=dtype, device=dev)
            rref = pd.spmv_planes_plain(noffs, rp, rw, n_in=n_in, nb=Lb,
                                        halo=g)
            for route in routes:
                ry = pd.spmv_planes_cuda(noffs, rp, rw, n_in=n_in, nb=Lb,
                                         route=route, halo=g)
                rel = float(torch.linalg.norm(ry - rref)
                            / torch.linalg.norm(rref))
                if rel > bar:
                    raise AssertionError(f"{label} random {route}: {rel}")
            p1, w1, n1 = shards[1], windows[1], live[1]
            csr = shard_plane_csr(noffs, p1, n_in, g)
            lib_rel = float(torch.linalg.norm(csr @ w1 - pd.spmv_planes_plain(
                noffs, p1, w1, n_in=n_in, nb=n1, halo=g))
                / torch.linalg.norm(csr @ w1))
            if lib_rel > bar:
                raise AssertionError(f"cuSPARSE on the shard: {lib_rel}")
            t = time_all(
                lambda: pd.spmv_planes_cuda(noffs, p1, w1, n_in=n_in, nb=n1,
                                            halo=g),
                lambda: pd.spmv_planes_plain(noffs, p1, w1, n_in=n_in, nb=n1,
                                             halo=g),
                lambda: csr @ w1, flush)
            whole_ms = (event_ms(lambda: pd.spmv_planes_cuda(
                noffs, planes, x.reshape(-1), n_in=n_in, nb=nb), 25,
                flush=flush), event_ms(lambda: pd.spmv_planes_cuda(
                    noffs, planes, x.reshape(-1), n_in=n_in, nb=nb), 25))
            n_out = p1.shape[0]
            t["bound"], t["bound_by"] = bound_ms(
                itemsize * (p1.numel() + w1.numel() + n_out * Lb),
                2 * p1.numel(), dtype)
            plan = pd.tiled_plan(noffs, p1, w1, n_in, halo=g)
            plan_txt = "no tiled plan" if plan is None else (
                f"tile {plan.tn}, {plan.n_tiles} tiles, {plan.stages} "
                f"stages, {plan.smem_bytes} B shared")
            print(f"{label}: Lb={Lb} nodes per shard, stored ghost width "
                  f"g={g} (node halo {max(map(abs, noffs))}), route {chosen} "
                  f"({plan_txt}); shard rows equal the whole-vector launch "
                  f"bit for bit on {'/'.join(routes)}; rel to plain "
                  + ", ".join(f"{r} {e[0]:.3e}" for r, e in errs.items())
                  + f" | shard 1: kernel {t['k_flush']:.4f} ms flushed, "
                  f"{t['k']:.4f} ms L2-warm | plain {t['p_flush']:.4f} / "
                  f"{t['p']:.4f} ms | cuSPARSE on the shard "
                  f"{t['lib_flush']:.4f} / {t['lib']:.4f} ms | bound "
                  f"{t['bound']:.4f} ms ({t['bound_by']}) | whole matrix, "
                  f"one launch: {whole_ms[0]:.4f} / {whole_ms[1]:.4f} ms",
                  flush=True)
            summary[(P, form, dtype)] = (errs[chosen][1], t)
    return summary


def halo_k2_phase(dev, mesh, pat, data64, flush) -> dict:
    """(h), K2: matrix 6's A (81 diagonals) and S (123) in f32 and f64,
    D^-1 (7), and A in bf16 with f32 x, cut into 4 shards (A and D^-1 by
    the 'tl' rule, S by the 'bj' rule); checked and timed as K1."""
    nb, n = mesh.nv, 4 * mesh.nv
    inv = block4_inverse(diag_blocks_from_dia(pat.offsets, data64, nb),
                         pivot_eps=1e-300, shift=1e-8)
    s_off, s_data = scale_rows_dia(pat, data64, inv)
    dinv = block_diag_to_dia(inv)
    P = SHARDS
    rng = np.random.default_rng(2092)
    forms = (("A", pat.offsets, data64, 4 * 48, torch.float32, None),
             ("A", pat.offsets, data64, 4 * 48, torch.float64, None),
             ("S", s_off, s_data, 1, torch.float32, None),
             ("S", s_off, s_data, 1, torch.float64, None),
             ("Dinv", dinv.offsets, dinv.data, 4 * 48, torch.float32, None),
             ("A", pat.offsets, data64, 4 * 48, torch.float32,
              torch.bfloat16))
    summary = {}
    for form, offsets, d64, mult, x_dtype, store in forms:
        data = d64.to(store or x_dtype).contiguous()
        bar = 1e-6 if store is not None else BARS[x_dtype]
        L = tpart.scalar_shard_rows(n, offsets, P, mult)
        h = tpart.halo_of(offsets)
        x = torch.as_tensor(rng.standard_normal(n), dtype=x_dtype,
                            device=dev)
        shards = tpart.split_rows(data, L, [dev] * P).parts
        windows = tpart.exchange(tpart.split_rows(x, L, [dev] * P).parts, h)
        got = torch.cat([dia_ops.spmv_dia_cuda(offsets, d, w, halo=h)
                         for d, w in zip(shards, windows)])[:n]
        label = (f"K2 {form} {str(data.dtype)[6:]}"
                 + (f" x {str(x_dtype)[6:]}" if store else "")
                 + f" (K={len(offsets)}) with ghost rows, {P} shards")
        if not torch.equal(got, dia_ops.spmv_dia_cuda(offsets, data, x)):
            raise AssertionError(f"{label}: shard rows differ from the "
                                 "whole-vector launch")
        ref = torch.cat([dia_ops.spmv_dia_plain(offsets, d, w, halo=h)
                         for d, w in zip(shards, windows)])[:n]
        rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
        if rel > bar:
            raise AssertionError(f"{label}: rel {rel:.3e} (bar {bar})")
        rd = torch.randn(shards[1].shape, device=dev).to(data.dtype)
        rw = torch.randn(windows[1].shape, dtype=x_dtype, device=dev)
        rref = dia_ops.spmv_dia_plain(offsets, rd, rw, halo=h)
        rrel = float(torch.linalg.norm(
            dia_ops.spmv_dia_cuda(offsets, rd, rw, halo=h) - rref)
            / torch.linalg.norm(rref))
        if rrel > bar:
            raise AssertionError(f"{label} random ghosts: rel {rrel:.3e}")
        d1, w1 = shards[1], windows[1]
        csr = None if store else shard_csr(offsets, d1, h)
        t = time_all(lambda: dia_ops.spmv_dia_cuda(offsets, d1, w1, halo=h),
                     lambda: dia_ops.spmv_dia_plain(offsets, d1, w1, halo=h),
                     None if csr is None else (lambda: csr @ w1), flush)
        whole_ms = (event_ms(lambda: dia_ops.spmv_dia_cuda(offsets, data, x),
                             25, flush=flush),
                    event_ms(lambda: dia_ops.spmv_dia_cuda(offsets, data, x),
                             25))
        t["bound"], t["bound_by"] = bound_ms(
            d1.numel() * d1.element_size()
            + (w1.numel() + L) * w1.element_size(), 2 * d1.numel(), x_dtype)
        lib = "none (bf16 data)" if csr is None else \
            f"{t['lib_flush']:.4f} / {t['lib']:.4f} ms"
        print(f"{label}: L={L} rows per shard, ghost width {h}; shard rows "
              f"equal the whole-vector launch bit for bit; rel {rel:.3e}, "
              f"random ghosts {rrel:.3e} | shard 1: kernel "
              f"{t['k_flush']:.4f} ms flushed, {t['k']:.4f} ms L2-warm | "
              f"plain {t['p_flush']:.4f} / {t['p']:.4f} ms | cuSPARSE on the "
              f"shard {lib} | bound {t['bound']:.4f} ms ({t['bound_by']}) | "
              f"whole matrix, one launch: {whole_ms[0]:.4f} / "
              f"{whole_ms[1]:.4f} ms", flush=True)
        summary[(form, str(data.dtype), x_dtype)] = (
            float((got - ref).abs().max()), t)
    return summary


def halo_phase(dev, mesh, pat, data64, flush) -> tuple:
    phase("(h) K1 and K2 with ghost rows: matrix 6 in 4 and 8 shards, each "
          "shard against the whole-vector launch bit for bit")
    return (halo_k1_phase(dev, mesh, pat, data64, flush),
            halo_k2_phase(dev, mesh, pat, data64, flush))


def dryrun_phase(dev) -> dict:
    phase(f"(i) dryrun_multichip({SHARDS}, {dev}) and dryrun_wide({SHARDS}, "
          f"{dev})")
    reset_counters()
    multi = dryrun.dryrun_multichip(SHARDS, dev)
    counts = counters()
    if counts["K1 halo"] <= 0 or not no_plain_calls(counts):
        raise AssertionError(f"dryrun_multichip counts {counts}")
    wide = dryrun.dryrun_wide(SHARDS, dev)
    return {"multichip": multi, "wide": wide, "K1 halo": counts["K1 halo"]}


def dist_run(label: str, mesh, cfg, devices, n_steps: int,
             stokes_must_converge=True, max_newton=3) -> tuple:
    """The distributed solver through its API (Stokes + n_steps), counters
    reset just before and read just after, each step printed; then one
    more step counted alone.  Returns (solver, u, counts, per-step)."""
    phase(label)
    reset_counters()
    t0 = time.perf_counter()
    solver, _ = DistributedNavierStokesSolver.from_mesh(mesh, cfg,
                                                        devices=devices)
    print(f"{solver.placement()}; shard kernel {solver.shard_kernel_name()}"
          f"; prep {solver.prep_kind}, preconditioner "
          f"{solver.cfg.krylov.preconditioner}, coarse_cheby "
          f"{solver.cfg.krylov.coarse_cheby}, coarse_agg "
          f"{solver.cfg.krylov.coarse_agg}")
    u = solver.run(n_steps, monitor=False)
    _sync(devices[0])
    seconds = time.perf_counter() - t0
    counts = counters()
    st = solver.stokes_result
    print(f"Stokes: gmres={st.iters} converged={st.converged}")
    step_lines(label.split(":")[0], solver.history)
    print(f"setup + Stokes + {n_steps} steps {seconds:.3f} s; kernel counts "
          f"{counts}")
    if stokes_must_converge and not st.converged:
        raise AssertionError("Stokes solve did not converge")
    for step, s, _ in solver.history:
        if not s.converged or (max_newton and s.iters > max_newton):
            raise AssertionError(f"step {step}: newton={s.iters} "
                                 f"converged={s.converged}")
    if not no_plain_calls(counts) or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"plain calls or a non-finite state: {counts}")
    reset_counters()
    _, _, one = solver.step(u, u, torch.zeros_like(u))
    per_step = counters()
    print(f"one more step (newton={one.iters} gmres={one.lin_iters}): kernel "
          f"counts {per_step}")
    return solver, u, counts, per_step


def dist_main_phase(dev, matrix_id: int = 6) -> dict:
    """(j) matrix 6 at the CLI's float32 defaults over 4 shards of the
    card: 'auto' resolves to plain two_level 'tlp' (with a warning); every
    GMRES matvec is K1's ghost-row form; against the single-device solver
    at the same resolved config."""
    mesh = scaling_series_mesh(matrix_id)
    cfg = f32_flagship_cfg()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        solver, u, counts, per_step = dist_run(
            f"(j) the main distributed path: matrix {matrix_id}, float32 "
            "defaults, "
            f"{SHARDS} shards on {dev}, Stokes + 3 steps", mesh, cfg,
            [dev] * SHARDS, 3)
    print("warnings: " + "; ".join(str(w.message) for w in rec
                                   if "distribution" in str(w.message)))
    kr = solver.cfg.krylov
    if solver.prep_kind != "tlp" or kr.coarse_cheby or \
            solver.shard_kernel_name() != "plane_spmv_halo":
        raise AssertionError(f"{solver.prep_kind}, {kr}")
    if counts["K1 halo"] <= 0 or per_step["K1 halo"] <= 0 or counts["K2"] \
            or counts["K3"]:
        raise AssertionError(f"kernel counts {counts}, per step {per_step}")
    check_state(solver.disc.mesh, u)
    # the single-device solver at the same resolved config
    single_cfg = f32_flagship_cfg(krylov=dict(
        preconditioner="two_level", coarse_cheby=0, coarse_agg=kr.coarse_agg,
        coarse_dense_max=kr.coarse_dense_max))
    reset_counters()
    single = NavierStokesSolver(solver.disc.mesh, single_cfg, device=dev)
    us = single.run(3, monitor=False)
    _sync(dev)
    step_lines("single device", single.history)
    newton_d = [s.iters for _, s, _ in solver.history]
    newton_s = [s.iters for _, s, _ in single.history]
    lin_d = statistics.mean(s.lin_iters for _, s, _ in solver.history)
    lin_s = statistics.mean(s.lin_iters for _, s, _ in single.history)
    gap = rel_gap(u, us)
    ms_d = 1e3 * statistics.mean(sec for _, _, sec in solver.history)
    ms_s = 1e3 * statistics.mean(sec for _, _, sec in single.history)
    print(f"distributed against one device at the same config: Newton "
          f"{newton_d} / {newton_s}, mean GMRES per step {lin_d:.1f} / "
          f"{lin_s:.1f}, state gap after 3 steps rel {gap:.3e}; step "
          f"{ms_d:.2f} ms distributed ({SHARDS} shards, one card), "
          f"{ms_s:.2f} ms on one device", flush=True)
    if newton_d != newton_s or not 0.8 * lin_s <= lin_d <= 1.25 * lin_s \
            or gap > 1e-4:
        raise AssertionError("distributed and single-device runs disagree")
    return {"K1 halo": counts["K1 halo"], "K1 halo per step":
            per_step["K1 halo"], "step ms": ms_d, "single step ms": ms_s,
            "GMRES": lin_d, "single GMRES": lin_s}


def dist_scalar_phase(dev, matrix_id: int = 6) -> dict:
    """(k) the scalar paths over 4 shards at matrix 6: the float64 CLI
    default 'bj' and 'tl' float32 (spmv='pallas'), Stokes + 2 steps each,
    K2's ghost-row form counted; then CA-GMRES ('bj', neumann_order=0)
    through the one-exchange power sweep on a channel, on the card and on
    the CPU from one state."""
    mesh = scaling_series_mesh(matrix_id)
    bj_cfg = NSConfig(dt=1e-3, reynolds=300.0, delta=0.05, dtype="float64",
                      krylov=SolverConfig(),
                      stokes_krylov=SolverConfig(rtol=1e-12, atol=1e-12,
                                                 maxiter=2000))
    _, u, bj_counts, _ = dist_run(
        f"(k) 'bj', the float64 CLI default, matrix {matrix_id}, {SHARDS} "
        "shards, "
        "Stokes + 2 steps", mesh, bj_cfg, [dev] * SHARDS, 2,
        stokes_must_converge=False, max_newton=None)
    check_state(mesh, u)
    if bj_counts["K2 halo"] <= 0 or bj_counts["K1"]:
        raise AssertionError(f"'bj' counts {bj_counts}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        solver, u, tl_counts, _ = dist_run(
            f"(k) 'tl' float32 (spmv='pallas'), matrix {matrix_id}, {SHARDS} "
            "shards, Stokes + 2 steps", mesh,
            f32_flagship_cfg(krylov=dict(spmv="pallas")), [dev] * SHARDS, 2)
    check_state(mesh, u)
    if solver.prep_kind != "tl" or tl_counts["K2 halo"] <= 0 \
            or tl_counts["K1"]:
        raise AssertionError(f"'tl' counts {tl_counts}")
    # one device at the same resolved config (plain two_level, 'tl')
    kr = solver.cfg.krylov
    single = NavierStokesSolver(mesh, f32_flagship_cfg(krylov=dict(
        spmv="pallas", preconditioner="two_level", coarse_cheby=0,
        coarse_agg=kr.coarse_agg, coarse_dense_max=kr.coarse_dense_max)),
        device=dev)
    us = single.run(2, monitor=False)
    _sync(dev)
    step_lines("'tl' on one device, same config", single.history)
    lin_d = statistics.mean(st.lin_iters for _, st, _ in solver.history)
    lin_s = statistics.mean(st.lin_iters for _, st, _ in single.history)
    print(f"'tl' distributed against one device: mean GMRES per step "
          f"{lin_d:.1f} / {lin_s:.1f}, state gap rel {rel_gap(u, us):.3e}",
          flush=True)
    if [st.iters for _, st, _ in solver.history] != \
            [st.iters for _, st, _ in single.history] \
            or not 0.8 * lin_s <= lin_d <= 1.25 * lin_s:
        raise AssertionError("'tl' distributed and single-device disagree")

    phase(f"(k) CA-GMRES ('bj', neumann_order=0, restart 8) on channel(64, "
          f"2, 2), {SHARDS} shards: the one-exchange power basis, card "
          "against CPU")
    small = channel_mesh(64, 2, 2, length=10.0)
    kr = SolverConfig(method="ca_gmres", restart=8, neumann_order=0,
                      rtol=1e-8, atol=1e-14, maxiter=6000)
    ca_cfg = NSConfig(dt=0.01, reynolds=100.0, delta=0.1, dtype="float64",
                      krylov=kr, stokes_krylov=kr)
    # the shared state: a two-level GMRES Stokes solve on the card; one CA
    # solve of the first Newton system from it (a Newton step's later
    # systems depend on the first solve's own error, which the monomial
    # basis's conditioning makes differ beyond rounding)
    gm = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000,
                      preconditioner="two_level", coarse_agg=4)
    u0 = DistributedNavierStokesSolver(
        small, dataclasses.replace(ca_cfg, krylov=gm, stokes_krylov=gm),
        devices=[dev] * SHARDS).stokes_init().cpu()
    res = {}
    for d in (dev, CPU):
        s = DistributedNavierStokesSolver(small, ca_cfg,
                                          devices=[d] * SHARDS)
        s._ensure_prepared()
        prep = s._exact_prep
        if 8 * tpart.halo_of(prep.offsets) > prep.L:
            raise AssertionError("the power basis does not fit a shard")
        x0 = u0.to(d)
        F = s._residual_fn(x0)(x0)
        F = torch.where(s.disc.bc.is_bc, torch.zeros_like(F), F)
        reset_counters()
        t0 = time.perf_counter()
        sol = s._solve_prepared(prep, -F, kr)
        _sync(d)
        res[d.type] = (sol, counters(), time.perf_counter() - t0)
    (rg, cg_, tg), (rc, _, tc) = res["cuda"], res["cpu"]
    gap = rel_gap(rg.x.cpu(), rc.x)
    print(f"one CA-GMRES solve of the first Newton system: card gmres="
          f"{rg.iters} converged={rg.converged} {tg:.3f} s, counts {cg_}; "
          f"CPU gmres={rc.iters} converged={rc.converged} {tc:.3f} s; "
          f"solution gap rel {gap:.3e}", flush=True)
    # rel 1e-6: the monomial basis amplifies rounding (a 1e-15 change of
    # the right-hand side moves this solution by rel 1.4e-10 on the CPU)
    if not (rg.converged and rc.converged
            and abs(rg.iters - rc.iters) <= 1 and gap < 1e-6
            and cg_["K2 halo"] > 0 and no_plain_calls(cg_)):
        raise AssertionError("CA-GMRES on the card and on the CPU disagree")
    return {"bj K2 halo": bj_counts["K2 halo"],
            "tl K2 halo": tl_counts["K2 halo"],
            "K2 halo": bj_counts["K2 halo"] + tl_counts["K2 halo"],
            "CA K2 halo": cg_["K2 halo"]}


# --- the rest of the package (ROADMAP slice 16): phases (l)-(o) -----------

def block_ell_bench_phase() -> dict:
    """(l) The bench's two block-format variants on the card at matrix 6:
    within rel 1e-5 of the DIA reference (f32), timed in the same run as
    K2 and K1; returns each variant's us."""
    argv = ["--matrices", "6", "--kernel", "spmv"]
    phase("(l) spmv_bench.main(" + " ".join(argv) + "): the BCSR oracle "
          "and the block-ELL gather beside K2 and K1")
    reset_counters()
    rows = spmv_bench.main(argv)
    counts = counters()
    print(f"kernel counts in spmv_bench: {counts}")
    us = {r["name"]: r["us"] for r in rows}
    for name in spmv_bench.BLOCK_VARIANTS:
        err = next(r["rel_err"] for r in rows if r["name"] == name)
        if not err <= 1e-5:
            raise AssertionError(f"{name}: rel err {err}")
    if counts["K1"] <= 0 or counts["K2"] <= 0:
        raise AssertionError(f"kernel counts {counts}")
    return us


def create_mat_phase(matrix_id: int = 3) -> None:
    """(m) create_mat on the card (float64) and on the CPU: every .mtx
    re-read, headers and (row, col) equal, values within rel 1e-12; the
    .npz likewise."""
    phase(f"(m) create_mat --matrix-id {matrix_id} on the card and on the "
          "CPU, re-read by read_mtx")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--matrix-id", str(matrix_id), "--out"]
        t0 = time.perf_counter()
        card = create_mat.main(argv + [os.path.join(tmp, "card")])
        t1 = time.perf_counter()
        host = create_mat.main(argv + [os.path.join(tmp, "cpu"), "--device",
                                       "cpu"])
        print(f"create_mat: card {t1 - t0:.3f} s, CPU "
              f"{time.perf_counter() - t1:.3f} s")
        for kind in ("aij", "aijp", "baij4"):
            heads = []
            for path in (card[kind], host[kind]):
                with open(path) as f:
                    heads.append((f.readline(), f.readline()))
            n_a, r_a, c_a, v_a = read_mtx(card[kind])
            n_b, r_b, c_b, v_b = read_mtx(host[kind])
            err = float(np.linalg.norm(v_a - v_b) / np.linalg.norm(v_b))
            print(f"{kind}: {heads[0][1].strip()}, values rel {err:.3e}")
            if heads[0] != heads[1] or n_a != n_b or not (
                    np.array_equal(r_a, r_b) and np.array_equal(c_a, c_b)) \
                    or not err <= 1e-12:
                raise AssertionError(f"{kind}: the card's file differs")
        a, b = load_bcsr_npz(card["npz"]), load_bcsr_npz(host["npz"])
        err = rel_gap(a.values, b.values)
        if not (np.array_equal(a.indptr, b.indptr)
                and np.array_equal(a.indices, b.indices) and err <= 1e-12):
            raise AssertionError(f"npz differs (values rel {err:.3e})")


def census_reference() -> dict:
    """The JAX package's census rows, by id, from
    `benchlogs/layout_census.txt` (the commented table)."""
    rows = {}
    with open(os.path.join(ROOT, "benchlogs", "layout_census.txt")) as f:
        for line in f:
            parts = line.lstrip("#").split()
            if len(parts) == 10 and parts[0].isdigit():
                rows[int(parts[0])] = parts
    return rows


def census_phase(ids=tuple(range(1, 9))) -> None:
    """(n) The census with the native host library: every column but
    build_s equal to the JAX package's logged table."""
    phase("(n) layout_census --ids " + ",".join(map(str, ids))
          + " (the native pattern build)")
    if not native.available():
        raise AssertionError("the native host library is not loaded")
    rows = layout_census.main(["--ids", ",".join(map(str, ids))])
    ref = census_reference()
    keys = ("id", "ndof", "nnzb", "K", "N_D", "span_contig", "raw_mb",
            "dia_mb", "bdia_mb", "bdia_vs_dia")
    print("census build seconds: " + ", ".join(
        f"{r['id']}: {r['build_s']}" for r in rows))
    for r in rows:
        if [str(r[k]) for k in keys] != ref[r["id"]]:
            raise AssertionError(f"census row {r} against {ref[r['id']]}")


def drift_phase(dev, matrix_id: int = 4, steps: int = 12) -> dict:
    """(o) The f32-against-f64 drift curve on the card, held to the JAX
    package's slow test's bars; returns the rows and the counts."""
    phase(f"(o) accuracy_drift --matrix-id {matrix_id} --steps {steps} on "
          "the card (f32 'tlp' against f64 'bj')")
    reset_counters()
    res = accuracy_drift.run_drift(matrix_id, steps, 1e-3, device=dev)
    counts = counters()
    print(f"kernel counts in accuracy_drift: {counts}")
    d = dict(res.rows)
    # tests/test_accuracy.py:65-79: the bound and the non-secular trend
    if not (max(d.values()) < 8e-3 and d[steps] < 1.5 * d[3]):
        raise AssertionError(f"drift curve {res.rows}")
    if counts["K1"] <= 0 or counts["K2"] <= 0 or not no_plain_calls(counts):
        raise AssertionError(f"kernel counts {counts}")
    return {"rows": res.rows, "counts": counts}


def ca_bench_phase(matrix_id: int = 6) -> dict:
    """(o) ca_bench on the card: both tables, GMRES(30) converged, every
    apply through K2."""
    argv = ["--matrix-id", str(matrix_id)]
    phase("(o) ca_bench.main(" + " ".join(argv) + ")")
    reset_counters()
    res = ca_bench.main(argv)
    counts = counters()
    print(f"kernel counts in ca_bench: {counts}")
    if not res["sweep"]["gmres:30"][3] or counts["K2"] <= 0 \
            or not no_plain_calls(counts):
        raise AssertionError(f"ca_bench: {res}, {counts}")
    return res


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def kernel_entry(name: str, launches: int, abs_err: float, t: dict,
                 entry_name=None, form=None) -> dict:
    """The summary line's entry of kernel `name` (a key of KERNELS); a
    second entry of one kernel, for another form, takes `entry_name`."""
    _, source, replaces = KERNELS[name]
    entry = {"name": entry_name or name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": abs_err, "ms": t["k_flush"],
             "plain_ms": t["p_flush"], "bound_ms": t["bound"],
             "bound_by": t["bound_by"],
             "library_ms": t["lib_flush"]}
    if form:
        entry["form"] = form
    return entry


def main() -> int:
    kind = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    mesh, pat, data64 = m6_operator(dev)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    k1 = k1_phase(dev, mesh, pat, data64, flush)
    k2 = k2_phase(dev, mesh, pat, data64, flush)
    k2_bf16 = k2_bf16_phase(dev, mesh, pat, data64, flush)
    route_sweep_phase(dev, pat, flush)
    k1_schur = k1_schur_phase(dev, flush)
    k3 = k3_phase(dev, flush)
    k4 = k4_phase(dev, pat, data64, flush)
    halo_k1, halo_k2 = halo_phase(dev, mesh, pat, data64, flush)
    del flush, data64
    k1_launches, plane_lin, plane_out = plane_path_phase()
    tf32_phase(plane_out)
    del plane_out
    k3_launches = plane_cgs2_phase(plane_lin)
    k2_launches = scalar_path_phase(plane_lin)
    k3_comp_launches = scalar_comp_phase()
    f64_launches = f64_default_phase()
    bf16_launches, _ = bf16_path_phase("tl")
    bf16_path_phase("bj")
    msh_phase()
    cli_io_phase()
    sch_counts, sch_lin, _, _ = schur_path_phase(8, 3)
    k3_sch_launches = schur_cgs2_phase(sch_lin)
    schur_path_phase(9, 2)
    m10_counts, _, _, m10_forms = schur_path_phase(10, 1)
    golden_phase(dev)
    k4_launches = bench_phase()
    bench_tools_phase()
    disc_cache_phase()
    options = {
        "(a) reference mode": reference_mode_phase(dev),
        "(b) golden reference mode": golden_reference_phase(dev),
        "(c) linear coarse": linear_coarse_phase(),
        "(d) smoothed aggregation": sa_phase(dev),
        "(e) CA-GMRES": ca_gmres_phase(dev),
        "(f) deflation": deflation_phase(),
        "(g) CG and ILU": cg_ilu_phase(dev),
    }
    print("launches on the solver-option paths: " + json.dumps(
        options, default=str))
    distributed = {"(i) dryruns": dryrun_phase(dev),
                   "(j) main path": dist_main_phase(dev),
                   "(k) scalar paths": dist_scalar_phase(dev)}
    print("the distributed paths: " + json.dumps(distributed, default=str))
    block_us = block_ell_bench_phase()
    create_mat_phase()
    census_phase()
    drift = drift_phase(dev)
    ca = ca_bench_phase()
    print("the rest of the package: " + json.dumps(
        {"(l) us": block_us, "(o) drift": drift["rows"],
         "(o) ca_bench": ca}, default=str))

    print(f"K2 launches: scalar two-level path {k2_launches}, float64 "
          f"default {f64_launches}, bf16 form on 'tl' {bf16_launches}; K3 "
          f"launches: plane path {k3_launches}, "
          f"'tl' with pallas_comp {k3_comp_launches}, Schur tier at matrix "
          f"8 {k3_sch_launches}")
    print("phase wall seconds:")
    phase_seconds()
    s_hat = {k: v for k, v in sch_counts["K1 forms"].items() if k[1] == 65}
    s_err, s_t, _ = k1_schur[(8, "1x1 S_hat", torch.float32)]
    s_hat_m10 = sum(v for k, v in m10_counts["K1 forms"].items()
                    if k[1] == 65)
    m10_err, m10_t, _ = m10_forms["1x1 S_hat"]
    print(json.dumps({"kernels": [
        kernel_entry("plane_spmv", k1_launches, *k1[("4x4", torch.float32)]),
        kernel_entry("plane_spmv", sum(s_hat.values()), s_err, s_t,
                     entry_name="plane_spmv_s_hat",
                     form="S_hat 1x1 on 65 offsets, matrix 8 'sch' path"),
        kernel_entry("plane_spmv", s_hat_m10, m10_err, m10_t,
                     entry_name="plane_spmv_s_hat_m10",
                     form="S_hat 1x1 on 65 offsets, matrix 10 'sch' path "
                          "(the run's own prep)"),
        kernel_entry("dia_spmv", k2_launches, *k2[("A", torch.float32)]),
        kernel_entry("dia_spmv_bf16", bf16_launches,
                     *k2_bf16[("A", torch.float32)],
                     form="A bf16 operator, float32 x, matrix 6 'tl' path "
                          "with matvec_dtype='bfloat16'"),
        kernel_entry("cgs2_project", k3_launches,
                     *k3[(torch.float32, 117_760, 15, False)]),
        kernel_entry("spmpv_dia", k4_launches, *k4[(torch.float32, 2)]),
        kernel_entry("plane_spmv_halo",
                     distributed["(j) main path"]["K1 halo"],
                     *halo_k1[(SHARDS, "4x4", torch.float32)],
                     form=f"4x4 float32 with ghost rows, one of {SHARDS} "
                          "shards of matrix 6; launches: the (j) "
                          "distributed 'tlp' run"),
        kernel_entry("dia_spmv_halo",
                     distributed["(k) scalar paths"]["K2 halo"],
                     *halo_k2[("A", "torch.float32", torch.float32)],
                     form=f"A float32 with ghost rows, one of {SHARDS} "
                          "shards of matrix 6; launches: the (k) 'bj' and "
                          "'tl' distributed runs"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
