"""A float64 configuration through the harness on the CPU, at a test-only
tiny size (`benchmark/tests/data/*/tiny_bj64*.json`: the float64 defaults
of `python -m navierstokes_tpu_torch.run`, block-Jacobi with a Neumann-2
boost, on an 8x3x3 channel, whose inlet values float32 does not hold
exactly): read against the plain float64 reference, its control (the
answers at float32) that must fail, the float32 configurations' control
unchanged, K2's least bytes, what a traced segment keeps of the program's
counters, and the readers of those counters on synthetic readings."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import check, run, traffic
from benchmark.kernels import k2_bytes, peak
from benchmark.spec import HERE, ROOT, Spec, load_reader

DATA = HERE / "tests" / "data"
TINY = "tiny_bj64.early"
H100 = "NVIDIA H100 80GB HBM3"


def tiny_spec() -> Spec:
    """BENCHMARK.json with the tiny float64 cell in place of the real ones,
    every metric reported there."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny_bj64", "source": "test-only",
                         "file": "benchmark/tests/data/configs/"
                                 "tiny_bj64.json",
                         "reduced": [], "why": "test-only"}]
    bench["workloads"] = [{"name": TINY, "config": "tiny_bj64",
                           "traffic": "early", "chips": 1,
                           "why": "test-only"}]
    for metric in bench["per_layer"]:
        metric.pop("workloads", None)
    return Spec(bench, workload_dir=DATA / "workloads")


# One process runs the tiny cell once through `benchmark.run.run_cell`,
# traced, and reads one seed's answers as the program gave them and at
# float32 (`benchmark.control`).  A process of its own, as the benchmark
# runs: a test session with JAX loaded would have a run refuse it.
HARNESS = """
import importlib.util, json, sys, torch
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("tiny_bj64_test", {path!r})
tests = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tests)
from benchmark import control, run
cpu = torch.device("cpu")
ok = run.run_cell(tests.tiny_spec(), tests.TINY, 2**31 + 43, 0.01, True,
                  cpu)
rows = control.read_seeds(tests.tiny_spec(), tests.TINY, [2**31 + 47], 1,
                          cpu)
print(json.dumps({{"ok": ok, "rows": rows,
                  "forbidden": run.forbidden_modules()}}))
"""


@pytest.fixture(scope="module")
def harness_runs():
    code = HARNESS.format(root=str(ROOT), path=__file__)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_tiny_f64_cell_runs_correct_against_the_reference(harness_runs):
    """On the CPU, with no JAX loaded: the answers meet every limit, and
    the traced segment's host syncs reach their reader (no graph replays
    on the CPU, so no run-ahead share)."""
    result, checks = harness_runs["ok"]
    assert harness_runs["forbidden"] == []
    assert result["correct"] is True, checks
    assert result["failed"] == 0 and result["attempted"] == 3
    assert set(checks) == set(check.NAMES)
    assert result["metrics"]["syncs_per_step"]["value"] > 0
    assert "graph_ahead_pct" not in result["metrics"]


def test_the_float32_control_fails_the_tiny_f64_cell(harness_runs):
    """The same answers rounded to float32, the precision next below the
    configuration's, fail step_res and bc_err; as produced they pass."""
    limits = tiny_spec().cell(TINY)["limits"]
    row, = harness_runs["rows"]
    assert check.judge(row["program"], limits)[0], row
    assert not check.judge(row["control"], limits)[0], row
    for name in ("step_res", "bc_err"):
        assert row["control"][name] > limits[name], (name, row)


def test_the_float32_control_is_round_tf32_bit_for_bit():
    """A float32 configuration's control is TF32 as it was; a float64
    one's is float32, carried in float64; no other dtype has one."""
    gen = torch.Generator().manual_seed(2**31 + 5)
    x = torch.randn(4096, generator=gen) * torch.logspace(-20, 20, 4096)
    got = check.round_below(x, "float32")
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32),
                       check.round_tf32(x).view(torch.int32))
    x64 = x.double() * (1 + 1e-12)
    got = check.round_below(x64, "float64")
    assert got.dtype == torch.float64
    assert torch.equal(got, x64.float().double()) and not torch.equal(got,
                                                                      x64)
    with pytest.raises(ValueError):
        check.round_below(x, "float16")


@pytest.mark.parametrize("k, data, x, bound_us", [
    (123, 8, 8, 35.1),      # S f64
    (81, 4, 4, 11.6),       # A f32
    (7, 8, 8, 2.5),         # D^-1 f64
    (81, 2, 4, 6.0),        # A bf16 with f32 x
])
def test_k2_bytes_give_the_bound_of_each_form(k, data, x, bound_us):
    """K2's least bytes at matrix 6 (117,500 rows) over the H100's HBM
    bandwidth: each form's bound in microseconds."""
    us = 1e6 * k2_bytes(k, 117_500, data, x) / peak(H100, "hbm_bytes_per_s")
    assert round(us, 1) == bound_us
    assert k2_bytes(k, 100, data, x, halo=7) == \
        k2_bytes(k, 100, data, x) + 14 * x


def test_traced_keeps_what_the_counters_counted_over_the_segment():
    """The profiled segment reads K1's and K2's forms and the always-on
    counters before and after it, and keeps the change (a key first seen
    inside the segment counts whole)."""

    class Program:
        steps = 0

        def k1_forms(self):
            return {(4, 4, 15, "tiled", False): 100 + 146 * self.steps}

        def k2_forms(self):
            return {"float64/float64": 7 * self.steps} if self.steps else {}

        def counters(self):
            return {"syncs": 12 + 38 * self.steps,
                    "graph_replays": 34 * self.steps,
                    "graph_ahead": 32 * self.steps}

    program = Program()
    with run.Traced(program) as segment:
        program.steps = 20
    assert segment.capture.path
    assert segment.counted == {
        "k1_forms": {(4, 4, 15, "tiled", False): 2920},
        "k2_forms": {"float64/float64": 140},
        "counters": {"syncs": 760, "graph_replays": 680,
                     "graph_ahead": 640}}


def _readings(counters: dict, traced_steps: int = 20) -> SimpleNamespace:
    return SimpleNamespace(counters=counters,
                           window=traffic.Window(traced_steps=traced_steps))


@pytest.mark.parametrize("name, counters, traced_steps, expected", [
    ("graph_ahead_pct", {"graph_replays": 646, "graph_ahead": 613,
                         "syncs": 755}, 20, 100.0 * 613 / 646),
    ("graph_ahead_pct", {"graph_replays": 0, "graph_ahead": 0,
                         "syncs": 755}, 20, None),
    ("graph_ahead_pct", {}, 20, None),
    ("syncs_per_step", {"graph_replays": 646, "graph_ahead": 613,
                        "syncs": 755}, 20, 37.75),
    ("syncs_per_step", {"syncs": 755}, 0, None),
    ("syncs_per_step", {}, 20, None),
])
def test_counter_readers_read_synthetic_readings(name, counters,
                                                 traced_steps, expected):
    """Each reads the counters' change over the traced segment, and
    nothing without counters, replays or traced steps."""
    reader = load_reader(HERE / "metrics", name)
    value = reader.read(_readings(counters, traced_steps))
    if expected is None:
        assert value is None
    else:
        assert value == pytest.approx(expected, rel=1e-12)
