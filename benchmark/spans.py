"""A traced run of one cell with the program's own spans on.

    python3 -m benchmark.spans --workload m6_f32.early --seed 7 --seconds 20

The window is `benchmark.run --trace 1`'s: set-up, then segments replayed
for `--seconds`, the first profiled (`trace.Capture`).  Here the program's
spans (`navierstokes_tpu_torch/utils/profiling.py`) are on from before the
solver is built, and read three times: after set-up, at the end of the
profiled segment and at the window's end.  Host times come from the
untraced segments, where the profiler's host cost is absent.  The run
prints the span tree on standard error and, as the last line of standard
output, one JSON object: the per-layer metrics of `BENCHMARK.json`, the
readings below under `spans`, `breakdown` with `idle_by_span` beside
`idle_gaps`, and `device`.  No answer is compared: `benchmark.run` decides
`correct`.

Readings (None where the program has no spans or counter, as before they
existed, or the run has nothing to read):

  discretization_s          `setup.discretization`, set-up
  operator_prep_s           `setup.operator` under `setup.prepare`, set-up
  precond_ms_per_step       `pc.apply` over the untraced steps
  gmres_dispatch_ms_per_it  `gmres.iter` less its `sync` children, per
                            iteration, untraced segments
  sync_wait_ms_per_step     `sync` over the untraced steps
  syncs_per_step            the program's count of host reads over the
                            window's steps
  idle_in_gmres_pct         device idle inside `ns.gmres.iter` over all
                            device idle of the profiled segment

`benchmark.run` does not turn spans on: its runs measure the program as
users run it.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict

import torch

from benchmark import run, traffic
from benchmark.reference.mesh import mesh_from_config
from benchmark.reference.padding import plane_rows
from benchmark.reference.problem import dirichlet
from benchmark.spec import Spec
from benchmark.system import System
from benchmark.trace import ANNOTATION, DEVICE_CATS, _union

PREFIX = "ns."
OUTSIDE = "outside"         # idle with no program span open


class TracedSystem(System):
    """The system with the program's span log and sync counter read; a
    program without them reads as having none."""

    @staticmethod
    def _profiling():
        try:
            from navierstokes_tpu_torch.utils import profiling
        except ImportError:
            return None
        return profiling if hasattr(profiling, "enable") else None

    @classmethod
    def tracing(cls) -> bool:
        """Turn the program's spans on; False where it has none."""
        profiling = cls._profiling()
        if profiling is None:
            return False
        profiling.enable()
        return True

    @classmethod
    def untracing(cls) -> None:
        profiling = cls._profiling()
        if profiling is not None:
            profiling.disable()

    @classmethod
    def spans(cls) -> dict:
        """{(name, parent): (count, total s, self s)}; {} with spans off."""
        profiling = cls._profiling()
        log = profiling.active() if profiling is not None else None
        return log.snapshot() if log is not None else {}

    @classmethod
    def syncs(cls):
        """The program's count of host reads; None where it keeps none."""
        profiling = cls._profiling()
        return getattr(profiling, "syncs", None)

    @classmethod
    def tree(cls) -> str:
        """The span tree as the program prints it; "" with spans off."""
        profiling = cls._profiling()
        log = profiling.active() if profiling is not None else None
        return log.report() if log is not None else ""


class Traced(run.Traced):
    """`benchmark.run`'s profiled segment, the span log read at its end
    (`.spans`)."""

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.spans = self.system.spans()
        return False


def _trace_events(path: str) -> tuple:
    """(profiled windows, device intervals, `ns.` spans) of a trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    windows, dev, spans = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        item = (s, s + float(e["dur"]))
        name, cat = e.get("name", ""), e.get("cat", "").lower()
        if cat == "user_annotation" and name == ANNOTATION:
            windows.append(item)
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append(item + (name[len(PREFIX):],))
        elif cat in DEVICE_CATS:
            dev.append(item)
    return sorted(windows), sorted(dev), sorted(spans,
                                                key=lambda x: (x[0], -x[1]))


def idle_gaps(windows: list, dev: list) -> list:
    """The device's idle intervals inside the windows, as `reduce_trace`
    finds them (us)."""
    out = []
    for ws, we in windows:
        ops = [(max(s, ws), min(e, we)) for s, e in dev if s < we and e > ws]
        _, gaps = _union(ops)
        edges = ([(ws, ops[0][0])] if ops else []) + gaps + (
            [(max(e for _, e in ops), we)] if ops else [(ws, we)])
        out += [(gs, ge) for gs, ge in edges if ge > gs]
    return out


def innermost(spans: list, points: list) -> list:
    """The name of the innermost span open at each of the sorted points,
    None where none is; spans nest, sorted by start (longer first)."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def idle_by_span(path: str, top: int = 10) -> dict:
    """The profiled segment's device idle by program span: `idle_by_span`,
    idle seconds by the innermost `ns.` span open at each gap's midpoint
    (top `top`, in the form of `reduce_trace`'s `idle_gaps`), the share of
    idle under any span, and the idle seconds inside `gmres.iter`."""
    windows, dev, spans = _trace_events(path)
    gaps = idle_gaps(windows, dev)
    mids = sorted((gs + ge) / 2 for gs, ge in gaps)
    by_mid = dict(zip(mids, innermost(spans, mids)))
    idle = defaultdict(float)
    for gs, ge in gaps:
        idle[by_mid[(gs + ge) / 2] or OUTSIDE] += ge - gs
    iters = [(s, e) for s, e, name in spans if name == "gmres.iter"]
    starts = [s for s, _ in iters]
    in_gmres = 0.0
    for gs, ge in gaps:
        j = max(bisect.bisect_right(starts, gs) - 1, 0)
        while j < len(iters) and iters[j][0] < ge:
            in_gmres += max(0.0, min(ge, iters[j][1]) - max(gs, iters[j][0]))
            j += 1
    total = sum(idle.values())
    rank = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"idle_by_span": [[n[:200], t * 1e-6] for n, t in rank],
            "device_ops": len(dev), "idle_s": total * 1e-6,
            "idle_in_spans_pct": 100.0 * (1 - idle.get(OUTSIDE, 0.0) / total)
            if total else None,
            "idle_in_gmres_s": in_gmres * 1e-6}


def implied_syncs(a: dict, b: dict, steps: int):
    """The host reads per step that the code implies from snapshot a to b:
    one per Newton check, and per GMRES solve one before the first cycle,
    one per cycle (the two together: `gmres.restart` spans) and one per
    iteration.  None without spans."""
    if not b or not steps:
        return None
    return sum(_delta(a, b, name, part=0) for name in (
        "newton.check", "gmres.restart", "gmres.iter")) / steps


def _delta(a: dict, b: dict, name: str, parent=..., part: int = 1) -> float:
    """Spans named `name` (under `parent`, any if ...) from snapshot a to
    b: count (part 0), total (1) or self seconds (2)."""
    def total(snap):
        return sum(v[part] for (n, p), v in snap.items()
                   if n == name and (parent is ... or p == parent))
    return total(b) - total(a)


def readings(marks: dict, syncs: dict, window, idle: dict | None) -> dict:
    """The seven readings from the snapshots at "setup", "traced" and
    "end", the sync counts at "setup" and "end", the window, and the
    profiled segment's idle (`idle_by_span`)."""
    setup, traced, end = marks["setup"], marks["traced"], marks["end"]
    steps = window.steps - window.traced_steps
    iters = _delta(traced, end, "gmres.iter", part=0)
    out = dict.fromkeys((
        "discretization_s", "operator_prep_s", "precond_ms_per_step",
        "gmres_dispatch_ms_per_it", "sync_wait_ms_per_step",
        "syncs_per_step", "idle_in_gmres_pct"))
    if setup:
        out["discretization_s"] = _delta({}, setup, "setup.discretization")
        out["operator_prep_s"] = _delta({}, setup, "setup.operator",
                                        "setup.prepare")
    if steps > 0 and end:
        out["precond_ms_per_step"] = 1e3 * _delta(traced, end,
                                                  "pc.apply") / steps
        out["sync_wait_ms_per_step"] = 1e3 * _delta(traced, end,
                                                    "sync") / steps
    if iters:
        out["gmres_dispatch_ms_per_it"] = 1e3 * (
            _delta(traced, end, "gmres.iter")
            - _delta(traced, end, "sync", "gmres.iter")) / iters
    if syncs["end"] is not None and window.steps:
        out["syncs_per_step"] = (syncs["end"] - syncs["setup"]) / window.steps
    if idle and idle["device_ops"] and idle["idle_s"] and marks["traced"]:
        out["idle_in_gmres_pct"] = 100.0 * idle["idle_in_gmres_s"] \
            / idle["idle_s"]
    return out


def run_spans(spec: Spec, name: str, seed: int, seconds: float,
              device: torch.device) -> tuple:
    """(result, span tree text): one traced run of the cell with the
    program's spans on."""
    from benchmark.trace import reduce_trace

    cell = spec.cell(name)
    cfg = spec.config(cell["config"])
    cuda = device.type == "cuda"
    TracedSystem.tracing()
    try:
        coords, tets, tags = mesh_from_config(cfg["mesh"])
        is_bc, _ = dirichlet(coords, tags)
        t = time.perf_counter()
        system = TracedSystem(cfg, coords, tets, tags, device)
        system.prepare()
        system.sync()
        prep_s = time.perf_counter() - t
        t = time.perf_counter()
        u_stokes = system.stokes()
        system.sync()
        stokes_s = time.perf_counter() - t
        pert = traffic.perturbation(coords, ~is_bc, cell["perturbation"],
                                    seed)
        start = u_stokes + torch.as_tensor(pert).to(device, u_stokes.dtype)
        start = traffic.lead_in(system, start, cell["start_step"])
        traffic.run_segment(system, start, cell["segment_steps"])
        system.sync()
        setup_s = run.process_age()
        marks = {"setup": system.spans()}
        syncs = {"setup": system.syncs()}
        segment = Traced(system)

        def traced(k):
            return segment if k == 0 else None

        window = traffic.replay(system, start, cell, seconds, seed,
                                traced=traced)
        marks["traced"] = segment.spans
        marks["end"], syncs["end"] = system.spans(), system.syncs()
        tree = system.tree()
        implied = implied_syncs(marks["setup"], marks["end"], window.steps)
        nvcc_s = system.nvcc_seconds()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        schur = system.schur_seconds()
    finally:
        TracedSystem.untracing()
    reduced = reduce_trace(segment.capture.path)
    idle = idle_by_span(segment.capture.path)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), "nvcc_s": nvcc_s,
           "busy_s": reduced["busy_s"], "window_s": reduced["window_s"]}
    power = run.power_limit() if cuda else None
    if power:
        dev["power_limit"] = power
    r = run.Readings(
        cell=cell, config=cfg, device=dev,
        spans={"prep_s": prep_s, "stokes_s": stokes_s}, window=window,
        setup_s=setup_s, peak_bytes=int(peak),
        nbp=plane_rows(coords.shape[0], cfg["krylov"].get("coarse_agg")),
        itemsize=torch.empty((), dtype=getattr(torch, cfg["dtype"])
                             ).element_size(),
        schur_seconds=schur, trace=reduced, **segment.counted)
    metrics = {}
    for entry, reader in spec.metrics(name, True):
        value = reader.read(r)
        if value is not None:
            metrics[entry["name"]] = float(value)
    result = {"metrics": metrics,
              "spans": readings(marks, syncs, window, idle),
              "implied_syncs_per_step": implied,
              "idle_in_spans_pct": idle["idle_in_spans_pct"],
              "steps": window.steps, "traced_steps": window.traced_steps,
              "breakdown": {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"],
                            "idle_by_span": idle["idle_by_span"]},
              "device": dev}
    return result, tree


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        run.log(f"{args.workload} needs a CUDA device")
        return 2
    result, tree = run_spans(Spec.load(), args.workload, args.seed,
                             args.seconds, torch.device("cuda", 0))
    run.log(tree or "the program records no spans")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
