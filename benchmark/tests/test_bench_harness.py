"""The harness end to end on the CPU at a test-only tiny size (the
kernels' plain versions), the files it finds by name, the faults the
comparison must catch, and the run on the card (marked `cuda`).

    python -m pytest benchmark/tests -q            # CPU
    python -m pytest benchmark/tests -q -m cuda    # on the card
"""

import json
import re
import subprocess
import sys

import pytest
import torch

from benchmark import check, control, run, traffic
from benchmark.spec import HERE, ROOT, Spec, load_json, load_reader
from benchmark.system import System, solver_config

DATA = HERE / "tests" / "data"
TINY = "tiny_tlp.early"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def tiny_spec() -> Spec:
    """BENCHMARK.json with the test-only tiny cell in place of the real
    ones, every metric reported there."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny_tlp", "source": "test-only",
                         "file": "benchmark/tests/data/configs/tiny_tlp.json",
                         "reduced": [], "why": "test-only"}]
    bench["workloads"] = [{"name": TINY, "config": "tiny_tlp",
                           "traffic": "early", "chips": 1,
                           "why": "test-only"}]
    for metric in bench["per_layer"]:
        metric.pop("workloads", None)
    return Spec(bench, workload_dir=DATA / "workloads")


@pytest.fixture(scope="module")
def cpu_run():
    return run.run_cell(tiny_spec(), TINY, 2**31 + 17, 1.0, False,
                        torch.device("cpu"))


def test_every_cell_config_and_metric_loads_by_name():
    spec = Spec.load()
    for cell in spec.bench["workloads"]:
        merged = spec.cell(cell["name"])
        cfg = spec.config(merged["config"])
        assert cfg["name"] == merged["config"]
        assert set(merged["limits"]) == set(check.NAMES)
    for key in ("end_to_end", "per_layer"):
        for entry in spec.bench[key]:
            reader = load_reader(spec.metric_dir, entry["name"])
            assert reader.UNIT == entry["unit"]
            assert reader.SOURCE == entry["source"]
            if key == "per_layer":
                assert reader.LAYER == entry["layer"]
                assert reader.MOVES == entry["moves"]


def test_files_kept_for_later_cells_load():
    """Every traffic file names a configuration file, carries the limits
    of each compared number, and every metric file is a reader: a cell
    whose files are here comes into BENCHMARK.json by its entries alone."""
    for path in sorted((HERE / "workloads").glob("*.json")):
        cell = load_json(path)
        assert cell["name"] == path.stem
        cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
        assert cfg["name"] == cell["config"]
        assert set(cell["limits"]) == set(check.NAMES)
        assert cell["segment_steps"] > 0 and cell["chips"] == 1
    for path in sorted((HERE / "metrics").glob("*.py")):
        if path.stem != "__init__":
            reader = load_reader(HERE / "metrics", path.stem)
            assert UNIT.match(reader.UNIT) and callable(reader.read)


def test_benchmark_json_keeps_the_contract():
    bench = load_json(ROOT / "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for entry in (bench["configs"] + bench["workloads"] + bench["end_to_end"]
                  + bench["per_layer"]):
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]


def run_main_contract(cfg: dict) -> None:
    """Assert that a configuration file builds the solver settings that
    `python -m navierstokes_tpu_torch.run` takes for its dtype on the
    card: float32's flagship or float64's defaults, nothing else."""
    from navierstokes_tpu_torch.config import NewtonConfig, SolverConfig
    from navierstokes_tpu_torch.run import default_f32_krylov

    assert cfg["dtype"] in ("float32", "float64"), cfg["dtype"]
    ns = solver_config(cfg)
    assert (ns.dt, ns.reynolds, ns.delta) == (1e-3, 300.0, 0.05)
    if ns.dtype == "float32":
        assert ns.krylov == default_f32_krylov()
        assert ns.stokes_krylov == default_f32_krylov()
        assert ns.newton == NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                                         du_tol=float("inf"))
    else:
        assert ns.newton == NewtonConfig()
        assert ns.krylov == SolverConfig()
        assert ns.stokes_krylov == SolverConfig(rtol=1e-12, atol=1e-12,
                                                maxiter=2000)


@pytest.mark.parametrize("path", sorted((HERE / "configs").glob("*.json")),
                         ids=lambda p: p.name)
def test_config_files_build_what_run_main_builds_for_their_dtype(path):
    run_main_contract(load_json(path))


@pytest.mark.parametrize("keys, value", [
    (("newton", "rtol"), 1e-5), (("newton", "atol"), 1e-6),
    (("newton", "stol"), 1e-7), (("newton", "du_tol"), None),
    (("dtype",), "float64"), (("dtype",), "float16"),
], ids=lambda v: "/".join(v) if isinstance(v, tuple) else repr(v))
def test_the_solver_contract_refuses_a_changed_file(keys, value):
    """The f32 flagship's file with one Newton tolerance or its dtype
    changed builds no solver that `run` builds."""
    cfg = load_json(HERE / "configs" / "m6_f32.json")
    entry = cfg
    for key in keys[:-1]:
        entry = entry[key]
    entry[keys[-1]] = value
    with pytest.raises(AssertionError):
        run_main_contract(cfg)


def test_a_float64_file_round_trips_through_solver_config():
    """JSON null is Newton's du_tol None (atol, the reference's rule)."""
    cfg = load_json(DATA / "configs" / "tiny_bj64.json")
    assert cfg["newton"]["du_tol"] is None
    assert solver_config(cfg).newton.du_tol is None
    run_main_contract(cfg)


def test_cpu_run_prints_the_contracts_line(cpu_run):
    result, checks = cpu_run
    assert RESULT_KEYS <= set(result)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, checks
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"step_ms_p95", "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0
    json.dumps(result)


def test_replay_holds_the_work_per_step_fixed(cpu_run):
    """Every segment is the same steps: the attempted count is whole
    segments, and each segment repeats Newton and GMRES exactly."""
    result, _ = cpu_run
    seg = load_json(DATA / "workloads" / f"{TINY}.json")["segment_steps"]
    assert result["attempted"] % seg == 0 and result["attempted"] >= seg

    spec = tiny_spec()
    cell = spec.cell(TINY)
    cfg = spec.config(cell["config"])
    from benchmark.reference.mesh import mesh_from_config
    coords, tets, tags = mesh_from_config(cfg["mesh"])
    system = System(cfg, coords, tets, tags, "cpu")
    start = system.stokes()
    counts = []
    for _ in range(3):
        w = traffic.Window()
        traffic.run_segment(system, start, seg, window=w)
        counts.append((w.newton, w.gmres))
    assert counts[0] == counts[1] == counts[2]


def test_nvcc_seconds_are_reported_apart(monkeypatch):
    """The seconds the program spent in nvcc come from its own counter and
    stand apart in `device`; set-up keeps them, as a run that builds
    spends them in set-up."""
    from navierstokes_tpu_torch.ops import cuda_lib
    monkeypatch.setattr(cuda_lib, "nvcc_seconds", lambda: 12.5)
    result, _ = run.run_cell(tiny_spec(), TINY, 31, 0.2, False,
                             torch.device("cpu"))
    assert result["device"]["nvcc_s"] == 12.5
    assert result["metrics"]["setup_s"]["value"] > 0


def test_schur_seconds_read_the_held_preparation_and_fail_loudly():
    """schur_prep_s reads the Newton preparation the solver holds, with no
    method of the solver replaced; on the Schur tier a preparation with no
    seconds raises instead of leaving the metric silent."""
    from types import SimpleNamespace

    class Solver(SimpleNamespace):
        pass

    system = System.__new__(System)
    system.solver = Solver(prep_kind="sch", _exact_prep=SimpleNamespace(
        seconds={"s_hat": 1.5, "power": 2.0}))
    assert system.schur_seconds() == {"s_hat": 1.5, "power": 2.0}
    reader = load_reader(HERE / "metrics", "schur_prep_s")
    assert reader.read(SimpleNamespace(schur_seconds={"a": 1.5, "b": 2.0})) \
        == 3.5
    assert reader.read(SimpleNamespace(schur_seconds={})) is None
    system.solver = Solver(prep_kind="sch", _exact_prep=SimpleNamespace(
        inner=SimpleNamespace(seconds={})))
    with pytest.raises(RuntimeError):
        system.schur_seconds()
    system.solver = Solver(prep_kind="tlp",
                           _exact_prep=SimpleNamespace(seconds={}))
    assert system.schur_seconds() == {}


def test_traced_cpu_run_reports_per_layer_metrics():
    result, _ = run.run_cell(tiny_spec(), TINY, 5, 0.5, True,
                             torch.device("cpu"))
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert {"prep_s", "stokes_s", "newton_per_step",
            "gmres_per_step"} <= set(result["metrics"])
    # no device on the CPU: no K1 time, no roofline, no kernel count
    assert "k1_roofline_pct" not in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_window_step_ms_leaves_the_traced_segment_out():
    """The per-layer step time is the window's wall time over its steps,
    less the profiled segment and its steps; with nothing traced it is the
    whole window's, and with every step traced there is nothing to read."""
    from types import SimpleNamespace

    reader = load_reader(HERE / "metrics", "window_step_ms")
    w = traffic.Window(seconds=3.0, step_seconds=[0.1] * 30)
    assert reader.read(SimpleNamespace(window=w)) == pytest.approx(100.0)
    w.traced_steps, w.traced_seconds = 10, 1.4
    assert reader.read(SimpleNamespace(window=w)) == pytest.approx(80.0)
    w.traced_steps = 30
    assert reader.read(SimpleNamespace(window=w)) is None


def test_replay_times_the_profiled_segment_apart():
    """The window records the wall time and the steps of the segment it
    profiles, and only of that one."""
    import contextlib
    import time

    from benchmark.system import StepResult

    class Slow:
        def step(self, u, u_old, delta_u):
            time.sleep(0.002)
            return StepResult(u, delta_u, 1, 2, True)

        def sync(self):
            pass

    params = {"segment_steps": 3}
    w = traffic.replay(Slow(), torch.zeros(8), params, 0.05, 1,
                       traced=lambda k: contextlib.nullcontext()
                       if k == 1 else None)
    assert w.segments >= 2 and w.traced_steps == 3
    assert 0.006 <= w.traced_seconds < w.seconds
    assert (w.newton, w.gmres) == (w.steps, 2 * w.steps)


def _faulty(monkeypatch, fault):
    step = System.step

    def broken(self, u, u_old, delta_u):
        res = step(self, u, u_old, delta_u)
        return res._replace(u=fault(u_old, res.u))

    monkeypatch.setattr(System, "step", broken)
    return run.run_cell(tiny_spec(), TINY, 23, 0.5, False,
                        torch.device("cpu"))


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    result, checks = _faulty(monkeypatch, lambda old, new: old.clone())
    assert result["correct"] is False
    assert checks["step_res"]["value"] > checks["step_res"]["limit"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    def alter(old, new):
        out = new.clone()
        out[4 * (out.numel() // 8)] += 0.1     # one velocity DoF
        return out

    result, checks = _faulty(monkeypatch, alter)
    assert result["correct"] is False


def test_the_tf32_control_comes_out_not_correct():
    """The control (the answers at TF32) fails a limit that the program's
    own answers meet, on three seeds."""
    spec = tiny_spec()
    limits = spec.cell(TINY)["limits"]
    rows = control.read_seeds(spec, TINY, [1, 2, 3], 1, torch.device("cpu"))
    for row in rows:
        assert check.judge(row["program"], limits)[0], row
        assert not check.judge(row["control"], limits)[0], row
        assert not check.judge(row["unchanged"], limits)[0], row
        assert not check.judge(row["altered"], limits)[0], row


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.14159265,
                      1e-30, 0.0])
    y = check.round_tf32(x)
    bits = y.view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == 1.0 + 2**-9
    assert abs(float(y[3]) + 3.14159265) < 2**-9 * 4


def test_nothing_the_run_imports_is_jax_or_the_jax_package():
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, %r)\n"
        "from benchmark.tests.test_bench_harness import tiny_spec, TINY\n"
        "from benchmark import run\n"
        "res, _ = run.run_cell(tiny_spec(), TINY, 3, 0.2, False,"
        " torch.device('cpu'))\n"
        "print(run.forbidden_modules(), res['correct'])\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "m6_f32.early",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card(card):
    spec = Spec.load()
    for cell in spec.bench["workloads"]:
        result, checks = run.run_cell(spec, cell["name"], 2**31 + 3, 2.0,
                                      False, card)
        assert result["correct"] is True, (cell["name"], checks)
        assert result["device"]["kind"] == torch.cuda.get_device_name(card)
