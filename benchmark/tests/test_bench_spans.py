"""The span tool (`benchmark/spans.py`) on the CPU: its seven readings on
the tiny cell's traced run, their arithmetic on a hand-written trace,
`reduce_trace` unmoved by the program's annotations, a program without
spans read as having none, and `benchmark.run` leaving spans off.

    python -m pytest benchmark/tests/test_bench_spans.py -q
"""

import json

import pytest
import torch

from benchmark import run, spans, trace
from benchmark.tests.test_bench_harness import TINY, tiny_spec

READINGS = ("discretization_s", "operator_prep_s", "precond_ms_per_step",
            "gmres_dispatch_ms_per_it", "sync_wait_ms_per_step",
            "syncs_per_step", "idle_in_gmres_pct")


@pytest.fixture(scope="module")
def tiny_run():
    return spans.run_spans(tiny_spec(), TINY, 2**31 + 41, 3.0,
                           torch.device("cpu"))


def test_the_readings_read_on_the_tiny_cell(tiny_run):
    """Every reading but the device-trace one reads a positive value (the
    CPU trace has no device events); the tree is printed; spans are off
    again after the run."""
    from navierstokes_tpu_torch.utils import profiling

    result, tree = tiny_run
    got = result["spans"]
    assert set(got) == set(READINGS)
    for name in READINGS[:-1]:
        assert got[name] is not None and got[name] > 0, name
    assert got["idle_in_gmres_pct"] is None
    steps = result["steps"]
    assert steps > result["traced_steps"] > 0
    assert result["implied_syncs_per_step"] == pytest.approx(
        got["syncs_per_step"], abs=1e-12)
    assert {"window_step_ms", "newton_per_step",
            "gmres_per_step"} <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps",
                                        "idle_by_span"}
    assert tree.startswith("Span") and "gmres.iter" in tree
    assert profiling.active() is None


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _write_trace(path, program_spans: bool):
    """One profiled window [0, 120] us: kernels at [10, 20] and [50, 60],
    a copy at [100, 110]; host ops; with `program_spans` the program's
    spans step [0, 95] > gmres.iter [6, 40] > sync [25, 34] and
    gmres.iter [45, 90]."""
    events = [
        _event(trace.ANNOTATION, "user_annotation", 0, 120),
        _event("k1", "kernel", 10, 10), _event("k2", "kernel", 50, 10),
        _event("Memcpy DtoH", "gpu_memcpy", 100, 10),
        _event("aten::mul", "cpu_op", 2, 6),
        _event("cudaMemcpyAsync", "cuda_runtime", 26, 8),
        _event("aten::add", "cpu_op", 70, 15),
    ]
    if program_spans:
        events += [
            _event("ns.step", "user_annotation", 0, 95),
            _event("ns.gmres.iter", "user_annotation", 6, 34),
            _event("ns.sync", "user_annotation", 25, 9),
            _event("ns.gmres.iter", "user_annotation", 45, 45),
        ]
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_idle_by_span_and_idle_in_gmres_on_a_hand_written_trace(tmp_path):
    """Gaps [0, 10] (midpoint 5: step), [20, 50] (35: gmres.iter, the sync
    closed at 34), [60, 100] (80: gmres.iter), [110, 120] (115: no span).
    Inside gmres.iter: 4 + 20 + 5 + 30 = 59 of 90 us idle."""
    out = spans.idle_by_span(_write_trace(tmp_path / "t.json", True))
    assert out["idle_by_span"] == [["gmres.iter", pytest.approx(70e-6)],
                                   ["step", pytest.approx(10e-6)],
                                   [spans.OUTSIDE, pytest.approx(10e-6)]]
    assert out["idle_s"] == pytest.approx(90e-6)
    assert out["idle_in_gmres_s"] == pytest.approx(59e-6)
    assert out["idle_in_spans_pct"] == pytest.approx(100 * 80 / 90)
    marks = {"setup": {}, "traced": {("step", None): (1, 1.0, 0.1)},
             "end": {}}
    w = run.traffic.Window(step_seconds=[0.1] * 4, traced_steps=4)
    got = spans.readings(marks, {"setup": None, "end": None}, w, out)
    assert got["idle_in_gmres_pct"] == pytest.approx(100 * 59 / 90)
    assert got["syncs_per_step"] is None


def test_readings_from_snapshots():
    """Host readings take the untraced segments: the delta from the end of
    the profiled segment to the window's end, over the untraced steps or
    iterations; set-up readings the set-up snapshot."""
    setup = {("setup.discretization", None): (1, 2.0, 2.0),
             ("setup.operator", "setup.prepare"): (1, 3.0, 1.0),
             ("setup.operator", "stokes"): (1, 4.0, 1.0)}
    traced = {**setup, ("pc.apply", "gmres.iter"): (10, 0.5, 0.1),
              ("gmres.iter", "krylov.solve"): (10, 1.0, 0.2),
              ("sync", "gmres.iter"): (10, 0.1, 0.1)}
    end = {**setup, ("pc.apply", "gmres.iter"): (40, 0.8, 0.2),
           ("pc.apply", "krylov.solve"): (3, 0.1, 0.0),
           ("gmres.iter", "krylov.solve"): (40, 2.2, 0.5),
           ("sync", "gmres.iter"): (40, 0.4, 0.4),
           ("sync", "newton.check"): (6, 0.05, 0.05)}
    w = run.traffic.Window(step_seconds=[0.1] * 8, traced_steps=2)
    got = spans.readings({"setup": setup, "traced": traced, "end": end},
                         {"setup": 100, "end": 420}, w, None)
    assert got["discretization_s"] == 2.0
    assert got["operator_prep_s"] == 3.0
    assert got["precond_ms_per_step"] == pytest.approx(1e3 * 0.4 / 6)
    assert got["sync_wait_ms_per_step"] == pytest.approx(1e3 * 0.35 / 6)
    assert got["gmres_dispatch_ms_per_it"] == pytest.approx(
        1e3 * (1.2 - 0.3) / 30)
    assert got["syncs_per_step"] == 40.0
    assert got["idle_in_gmres_pct"] is None


def test_reduce_trace_is_the_same_with_and_without_program_spans(tmp_path):
    plain = trace.reduce_trace(_write_trace(tmp_path / "a.json", False))
    spanned = trace.reduce_trace(_write_trace(tmp_path / "b.json", True))
    assert plain == spanned
    assert dict(plain["idle_gaps"]) == {"aten::mul": pytest.approx(10e-6),
                                        "python": pytest.approx(40e-6),
                                        "aten::add": pytest.approx(40e-6)}


def test_a_program_without_spans_reads_none(monkeypatch):
    """As on a program from before the spans: the run goes through and
    every program reading is None."""
    monkeypatch.setattr(spans.TracedSystem, "_profiling",
                        staticmethod(lambda: None))
    result, tree = spans.run_spans(tiny_spec(), TINY, 7, 3.0,
                                   torch.device("cpu"))
    assert tree == ""
    assert all(v is None for v in result["spans"].values())
    assert result["metrics"]["window_step_ms"] > 0


def test_benchmark_run_leaves_spans_off(monkeypatch):
    """`benchmark.run` turns nothing on, traced or not: every step it
    times runs with spans off.  The sync counter (always on, as the launch
    counters) moves."""
    from benchmark.system import System
    from navierstokes_tpu_torch.utils import profiling

    seen = []
    step = System.step

    def watched(self, u, u_old, delta_u):
        seen.append(profiling.active())
        return step(self, u, u_old, delta_u)

    monkeypatch.setattr(System, "step", watched)
    before = profiling.syncs
    for traced in (False, True):
        result, _ = run.run_cell(tiny_spec(), TINY, 11, 0.2, traced,
                                 torch.device("cpu"))
        assert result["correct"] is True
    assert seen and seen == [None] * len(seen)
    assert profiling.syncs > before
