"""The benchmark's Schur cell (`m9_f32.early`) through the harness on the
CPU, at a test-only tiny size (`benchmark/tests/data/*/tiny_sch*.json`):
the pressure-Schur tier forced on a tiny channel, read against the plain
float64 reference, a fault the comparison must catch, and the readers of
the cell's per-layer metrics on synthetic readings."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import run, traffic
from benchmark.k1_form import tiled_form
from benchmark.kernels import K1_KERNEL
from benchmark.spec import HERE, ROOT, Spec, load_reader

DATA = HERE / "tests" / "data"
TINY = "tiny_sch.early"
CELL = "m9_f32.early"
READERS = ("schur_prep_s", "k1_sch_ms_per_step", "k1_sch_roofline_pct",
           "k1_shat_roofline_pct", "k1_f_roofline_pct")
H100 = "NVIDIA H100 80GB HBM3"
NBP = 249_728


def tiny_spec() -> Spec:
    """BENCHMARK.json with the tiny Schur cell in place of the real ones,
    every metric reported there."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny_sch", "source": "test-only",
                         "file": "benchmark/tests/data/configs/tiny_sch.json",
                         "reduced": [], "why": "test-only"}]
    bench["workloads"] = [{"name": TINY, "config": "tiny_sch",
                           "traffic": "early", "chips": 1,
                           "why": "test-only"}]
    for metric in bench["per_layer"]:
        metric.pop("workloads", None)
    return Spec(bench, workload_dir=DATA / "workloads")


def test_the_cell_reports_the_schur_metrics_traced():
    """The cell's traced runs report the five Schur metrics, m6's none."""
    spec = Spec.load()
    traced = {m["name"] for m, _ in spec.metrics(CELL, True)}
    assert set(READERS) <= traced
    assert not set(READERS) & {m["name"] for m, _ in
                               spec.metrics("m6_f32.early", True)}
    assert spec.config(spec.cell(CELL)["config"])["reduced"] == []


# One process runs the tiny cell twice through `benchmark.run.run_cell`,
# one segment each: as it is, then with each step returning its state
# unchanged.  A process of its own, as the benchmark runs: this test
# session has JAX loaded, which a run refuses.
HARNESS = """
import importlib.util, json, sys, torch
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("tiny_sch_test", {path!r})
tests = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tests)
from benchmark import run
from benchmark.system import System
cpu = torch.device("cpu")
ok = run.run_cell(tests.tiny_spec(), tests.TINY, 2**31 + 29, 0.01, False,
                  cpu)
step = System.step
System.step = lambda self, u, u_old, du: step(self, u, u_old, du)._replace(
    u=u_old.clone())
bad = run.run_cell(tests.tiny_spec(), tests.TINY, 41, 0.01, False, cpu)
print(json.dumps({{"ok": ok, "unchanged": bad,
                  "forbidden": run.forbidden_modules()}}))
"""


@pytest.fixture(scope="module")
def harness_runs():
    code = HARNESS.format(root=str(ROOT), path=__file__)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_tiny_schur_cell_runs_correct_against_the_reference(harness_runs):
    """On the CPU, with no JAX loaded: the answers meet every limit."""
    result, checks = harness_runs["ok"]
    assert harness_runs["forbidden"] == []
    assert result["correct"] is True, checks
    assert result["failed"] == 0 and result["attempted"] == 3
    assert set(checks) == {"step_res", "bc_err", "stokes_res"}
    assert set(result["metrics"]) == {"step_ms_p95", "setup_s"}


def test_tiny_schur_step_returning_its_state_is_not_correct(harness_runs):
    result, checks = harness_runs["unchanged"]
    assert result["correct"] is False
    assert checks["step_res"]["value"] > checks["step_res"]["limit"]


def _kernel(n_out: int, n_in: int, group: int = 0) -> str:
    return (f"void (anonymous namespace)::plane_spmv_tiled_kernel<float, "
            f"{n_out}, {n_in}, {group}>(CUtensorMap_st, float const*, float "
            "const*, float*, int, int, int, int, int, int, bool, (anonymous "
            "namespace)::TiledLayout)")


ROWS = ("void (anonymous namespace)::plane_spmv_rows_kernel<float, 1, false>"
        "(float const*, float const*, float*, int, int, int, int, "
        "(anonymous namespace)::NodeOffsets)")
# one traced step of matrix 9's 'sch' tier: launches by form, and each
# form's device us a launch
FORMS = {(4, 4, 15): (79, 96.5), (3, 3, 15): (154, 61.5),
         (1, 3, 15): (77, 29.3), (1, 1, 65): (154, 37.5)}


def readings(rows: tuple = ()) -> SimpleNamespace:
    """Synthetic readings of one traced step; each (n_out, n_in, offsets)
    of `rows` has one launch taken by the rows route."""
    k1 = {}
    kernels = [("void at::native::reduce_kernel<512, 1>", 5.0)]
    for (n_out, n_in, n_d), (n, us) in FORMS.items():
        k1[(n_out, n_in, n_d, "tiled", False)] = n
        kernels += [(_kernel(n_out, n_in, int(n_d == 15)), us)] * n
    for n_out, n_in, n_d in rows:
        k1[(n_out, n_in, n_d, "rows", False)] = 1
        kernels.append((ROWS.replace("<float, 1,", f"<float, {n_out},"), 50))
    return SimpleNamespace(
        device={"kind": H100}, window=traffic.Window(traced_steps=1),
        schur_seconds={"setup.schur.s_hat": 4.0, "setup.schur.power": 6.5},
        k1_forms=k1, nbp=NBP, itemsize=4,
        trace={"kernels": kernels, "busy_s": 0.05, "window_s": 0.06})


def _roofline(n_out, n_in, n_d):
    n, us = FORMS[(n_out, n_in, n_d)]
    least = 4 * NBP * (n_out * n_in * n_d + n_in + n_out)
    return 100.0 * least / 3.35e12 / (us * 1e-6)


def test_tiled_kernel_names_give_their_form():
    assert tiled_form(_kernel(3, 3, 1)) == (3, 3)
    assert tiled_form(_kernel(1, 1)) == (1, 1)
    assert tiled_form("plane_spmv_tiled_kernel<double, (int)1, (int)3, "
                      "(int)0>") == (1, 3)
    assert tiled_form(ROWS) is None and K1_KERNEL in ROWS


@pytest.mark.parametrize("name", READERS)
def test_schur_readers_read_synthetic_readings(name):
    reader = load_reader(HERE / "metrics", name)
    value = reader.read(readings())
    all_us = sum(n * us for n, us in FORMS.values())
    all_least = sum(n * 4 * NBP * (o * i * d + i + o)
                    for (o, i, d), (n, _) in FORMS.items())
    expected = {
        "schur_prep_s": 10.5,
        "k1_sch_ms_per_step": all_us * 1e-3,
        "k1_sch_roofline_pct": 100.0 * all_least / 3.35e12 / (all_us * 1e-6),
        "k1_shat_roofline_pct": _roofline(1, 1, 65),
        "k1_f_roofline_pct": _roofline(3, 3, 15),
    }[name]
    assert value == pytest.approx(expected, rel=1e-12)
    if name.endswith("roofline_pct"):
        assert 0 < value < 100


@pytest.mark.parametrize("name, rows, silent", [
    ("k1_shat_roofline_pct", (1, 1, 65), True),
    ("k1_shat_roofline_pct", (1, 3, 15), True),
    ("k1_shat_roofline_pct", (3, 3, 15), False),
    ("k1_f_roofline_pct", (3, 3, 15), True),
    ("k1_f_roofline_pct", (1, 1, 65), False),
])
def test_form_readers_are_silent_where_a_rows_launch_ran(name, rows, silent):
    """The rows route's kernel name has no NIN: a rows launch of an
    n_out x N form silences that n_out's reader, and only that one."""
    reader = load_reader(HERE / "metrics", name)
    value = reader.read(readings(rows=(rows,)))
    assert (value is None) == silent
    if not silent:
        assert value == reader.read(readings())


def test_form_readers_are_silent_without_a_trace_or_a_known_card():
    for name in READERS[1:]:
        reader = load_reader(HERE / "metrics", name)
        r = readings()
        r.trace = None
        assert reader.read(r) is None
        if name.endswith("roofline_pct"):
            r = readings()
            r.device = {"kind": "cpu"}
            assert reader.read(r) is None
