"""Run one cell of the benchmark once.

    python -m benchmark.run --workload m6_f32.early --seed 7 --seconds 20 \
        --trace 0

Set-up builds the mesh (the benchmark's frozen generator), the solver and
its prepared operators, solves Stokes, perturbs the start state from the
seed and runs one warm segment; the window then replays segments of
backward-Euler steps for `--seconds` (`benchmark/traffic.py`).  With
`--trace 1` the window's first segment runs under the profiler and the
line carries the per-layer metrics instead of the end-to-end ones.  After
the window the reference reads the answers (`benchmark/check.py`).  The
last line of standard output is the result, one JSON object; the last
lines of standard error give each compared number beside its limit.
Without a CUDA device the run exits with 2 and prints no result.
"""

from __future__ import annotations

import os
import time

_T0 = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (the kernel's clock where it
    gives one, else since this module was loaded)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, traffic  # noqa: E402
from benchmark.reference.mesh import mesh_from_config  # noqa: E402
from benchmark.reference.padding import plane_rows  # noqa: E402
from benchmark.reference.problem import Reference, dirichlet  # noqa: E402
from benchmark.spec import Spec  # noqa: E402
from benchmark.trace import Capture, reduce_trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "navierstokes_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


@dataclasses.dataclass
class Readings:
    """Everything a metric reader may read: the cell, the spans the
    benchmark took around the program's layers, the program's counters,
    the window and, in a traced run, the reduced trace."""

    cell: dict
    config: dict
    device: dict
    spans: dict
    window: traffic.Window
    setup_s: float
    peak_bytes: int
    nbp: int
    itemsize: int
    schur_seconds: dict
    k1_forms: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None
    k2_forms: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)


def counter_delta(before: dict, after: dict) -> dict:
    """What each counter of `after` counted since `before`."""
    return {k: v - before.get(k, 0) for k, v in after.items()}


class Traced:
    """Profiles one segment (`trace.Capture`) and keeps what the program's
    counters counted over it, read outside the profiled segment: K1's and
    K2's launches by form and the always-on counters (`.counted`, by the
    names of `Readings`' fields)."""

    READS = ("k1_forms", "k2_forms", "counters")

    def __init__(self, system):
        self.system = system
        self.capture = None
        self.counted = {}

    def _read(self) -> dict:
        return {name: getattr(self.system, name)() for name in self.READS}

    def __enter__(self):
        self._before = self._read()
        self.capture = Capture().__enter__()
        return self

    def __exit__(self, *exc):
        self.capture.__exit__(*exc)
        after = self._read()
        self.counted = {name: counter_delta(self._before[name], after[name])
                        for name in self.READS}
        return False


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device) -> tuple:
    """(result, checks): one run of the cell on `device`."""
    from benchmark.system import System

    cell = spec.cell(name)
    cfg = spec.config(cell["config"])
    cuda = device.type == "cuda"
    coords, tets, tags = mesh_from_config(cfg["mesh"])
    is_bc, _ = dirichlet(coords, tags)
    spans = {}

    t = time.perf_counter()
    system = System(cfg, coords, tets, tags, device)
    system.prepare()
    system.sync()
    spans["prep_s"] = time.perf_counter() - t
    t = time.perf_counter()
    u_stokes = system.stokes()
    system.sync()
    spans["stokes_s"] = time.perf_counter() - t
    log(f"{name}: prep {system.prep_kind} {spans['prep_s']:.3f} s, Stokes "
        f"{system.stokes_iters()} GMRES {spans['stokes_s']:.3f} s")
    stokes_host = u_stokes.cpu()

    pert = traffic.perturbation(coords, ~is_bc, cell["perturbation"], seed)
    start = u_stokes + torch.as_tensor(pert).to(device, u_stokes.dtype)
    del u_stokes
    start = traffic.lead_in(system, start, cell["start_step"])
    traffic.run_segment(system, start, cell["segment_steps"])
    system.sync()
    setup_s = process_age()
    nvcc_s = system.nvcc_seconds()
    log(f"{name}: set-up {setup_s:.3f} s, of which nvcc {nvcc_s:.3f} s")

    segments = []

    def traced(segment):
        if not trace or segment:
            return None
        segments.append(Traced(system))
        return segments[-1]

    window = traffic.replay(system, start, cell, seconds, seed,
                            traced=traced)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    log(f"{name}: {window.steps} steps in {window.seconds:.3f} s, "
        f"{window.segments} segments, Newton {window.newton}, GMRES "
        f"{window.gmres}, unconverged {window.unconverged}, non-finite "
        f"{window.nonfinite}")
    seg = cell["segment_steps"]
    log(f"{name}: segment ms " + " ".join(
        f"{1e3 * sum(window.step_seconds[i:i + seg]):.1f}"
        for i in range(0, window.steps, seg)))

    nbp = plane_rows(coords.shape[0], cfg["krylov"].get("coarse_agg"))
    itemsize = torch.empty((), dtype=getattr(torch, cfg["dtype"])
                           ).element_size()
    schur_seconds = system.schur_seconds()
    system.release()
    del system, start
    if cuda:
        torch.cuda.empty_cache()

    reduced, traced_counts = None, {}
    if trace:
        reduced = reduce_trace(segments[0].capture.path)
        traced_counts = segments[0].counted
        log(f"{name}: trace {segments[0].capture.path}")

    t = time.perf_counter()
    reference = Reference(coords, tets, tags, cfg, device)
    pairs = [(old, new) for _, _, old, new in
             traffic.checked(window, cell, seed)]
    numbers = check.readings(reference, stokes_host, pairs)
    correct, checks = check.judge(numbers, cell.get("limits", {}))
    del reference
    log(f"{name}: reference read {len(pairs)} steps in "
        f"{time.perf_counter() - t:.3f} s")

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), "nvcc_s": nvcc_s}
    if trace:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
    power = power_limit() if cuda else None
    if power:
        dev["power_limit"] = power
    r = Readings(cell=cell, config=cfg, device=dev, spans=spans,
                 window=window, setup_s=setup_s, peak_bytes=int(peak),
                 nbp=nbp, itemsize=itemsize, schur_seconds=schur_seconds,
                 trace=reduced, **traced_counts)
    metrics = {}
    for entry, reader in spec.metrics(name, trace):
        value = reader.read(r)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    result = {"correct": bool(correct and not window.nonfinite),
              "attempted": window.steps,
              "failed": window.unconverged + window.nonfinite,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = {k: {kk: _finite(vv) for kk, vv in v.items()}
                        for k, v in checks.items()}
    return result, checks


def _finite(x):
    return x if x is None or np.isfinite(x) else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = Spec.load()
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " here")
        return 2
    device = torch.device("cuda", 0)
    result, checks = run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), device)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    if result["device"].get("power_limit"):
        log(f"card: {result['device']['power_limit']}")
    for key, v in checks.items():
        log(f"check {key} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
