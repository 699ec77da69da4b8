"""The program's spans and its sync counter (`utils/profiling`) on the
f32 flagship path ('tlp') at the CLI's f32 defaults, on channel(3, 2, 2):
off by default and then recording nothing, the span tree of a step, the
count of host reads a step makes, the spans in a `torch.profiler` trace,
and the span tree `python -m navierstokes_tpu_torch.run --profile`
prints; and the spans the pressure-Schur tier ('sch') adds: its set-up
stages and its two cycles."""

import dataclasses
import json
import math

import pytest
import torch

from navierstokes_tpu_torch import run
from navierstokes_tpu_torch.config import NewtonConfig, NSConfig
from navierstokes_tpu_torch.mesh import channel_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.model import navier_stokes as ns
from navierstokes_tpu_torch.utils import profiling

CPU = torch.device("cpu")
MESH = channel_mesh(3, 2, 2)

# every span a 'tlp' solver opens from its construction through one step
# (newton.jacobian and newton.prep run in reference mode only)
TLP_SPANS = {
    "setup.discretization", "stokes", "setup.operator", "setup.coarse",
    "setup.cheby_lmax", "setup.assemble", "krylov.solve", "step",
    "setup.prepare", "setup.residual_ops", "newton.check", "gmres.restart",
    "gmres.iter", "gmres.orth", "gmres.update", "op.apply", "pc.apply",
    "pc.coarse", "pc.smooth", "sync",
}


# the spans the 'sch' set-up adds: one per stage of its host algebra
SCHUR_STAGES = {
    "setup.schur.to_host", "setup.schur.blocks", "setup.schur.planes",
    "setup.schur.s_hat", "setup.schur.coarse", "setup.schur.power",
    "setup.schur.to_device",
}


def f32_cfg(restart: int = 30, **krylov) -> NSConfig:
    """The CLI's float32 config (run.py), GMRES restarted every `restart`,
    with `krylov` changed."""
    kr = dataclasses.replace(run.default_f32_krylov(), restart=restart,
                             **krylov)
    return NSConfig(dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
                    newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                                        du_tol=float("inf")),
                    krylov=kr, stokes_krylov=kr)


@pytest.fixture(scope="module")
def traced():
    """A 'tlp' solver built, Stokes-initialized and stepped once with spans
    on: (solver, u0, log, stats, the log's snapshot before the step)."""
    log = profiling.enable()
    try:
        solver = NavierStokesSolver(MESH, f32_cfg(), device=CPU)
        u0 = solver.stokes_init()
        stokes = log.snapshot()
        _, _, stats = solver.step(u0, u0, torch.zeros_like(u0))
    finally:
        profiling.disable()
    assert solver.prep_kind == "tlp" and solver._exact_prep.cheby
    return solver, u0, log, stats, stokes


@pytest.fixture(scope="module")
def profiled(traced, tmp_path_factory):
    """One CPU `torch.profiler` session over two steps, each in an
    annotation of its own: "off" with spans off (as by default), then "on"
    with spans on.  (X events of the Chrome trace, the "on" step's log,
    the "off" step's stats, the fixture log before and after "off")."""
    solver, u0, log, _, _ = traced
    off_default = profiling.active() is None
    before = log.snapshot()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("off"):
            _, _, stats = solver.step(u0, u0, torch.zeros_like(u0))
        after = log.snapshot()
        on_log = profiling.enable()
        try:
            with torch.profiler.record_function("on"):
                solver.step(u0, u0, torch.zeros_like(u0))
        finally:
            profiling.disable()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    return events, on_log, stats, off_default, before, after


def _spans(events, name):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e["name"] == name
            and e.get("cat") == "user_annotation"]


def _inside(events, window, cat=None):
    (ws, we), = window
    return [e for e in events if ws <= float(e["ts"])
            and float(e["ts"]) + float(e["dur"]) <= we
            and (cat is None or e.get("cat") == cat)]


def test_spans_are_off_by_default_and_an_off_step_records_nothing(profiled):
    events, _, stats, off_default, before, after = profiled
    assert off_default and profiling.active() is None
    assert stats.converged and after == before
    off = _inside(events, _spans(events, "off"))
    assert any(e["name"].startswith("aten::") for e in off)
    assert not [e for e in off if e["name"].startswith(profiling.PREFIX)]


def test_span_tree_of_a_tlp_step_holds_every_span(traced):
    _, _, log, stats, stokes = traced
    snap = log.snapshot()
    assert {name for name, _ in snap} == TLP_SPANS
    for (name, parent), (n, total, self_s) in snap.items():
        assert n > 0 and 0 <= self_s <= total + 1e-9, (name, parent)
    assert snap[("step", None)][0] == 1
    assert snap[("newton.check", "step")][0] == stats.iters
    assert snap[("krylov.solve", "step")][0] == stats.iters - 1
    key = ("gmres.iter", "krylov.solve")
    assert snap[key][0] - stokes[key][0] == stats.lin_iters
    assert snap[("setup.operator", "setup.prepare")][0] == 1
    assert snap[("setup.operator", "stokes")][0] == 1
    for child in ("pc.smooth", "pc.coarse", "op.apply"):
        assert snap[(child, "pc.apply")][0] > 0
    assert snap[("op.apply", "pc.smooth")][0] > 0
    report = log.report()
    assert "\n  newton.check" in report and "\n    gmres.iter" in report


def test_syncs_of_a_step_are_what_the_code_implies(traced, monkeypatch):
    """Per solve one read before the first cycle, one per cycle and one per
    iteration; one per Newton check.  GMRES(4), so a solve runs several
    cycles; each ends at m iterations or at convergence."""
    m = 4
    solver = NavierStokesSolver(MESH, f32_cfg(restart=m),
                                disc=traced[0].disc, device=CPU)
    u0 = traced[1]
    solves = []
    real = ns.gmres

    def recorded(*args, **kwargs):
        res = real(*args, **kwargs)
        solves.append(res)
        return res

    monkeypatch.setattr(ns, "gmres", recorded)
    solver._ensure_prepared()
    before = profiling.syncs
    _, _, stats = solver.step(u0, u0, torch.zeros_like(u0))
    counted = profiling.syncs - before
    assert stats.converged and len(solves) == stats.iters - 1
    assert all(r.converged for r in solves)
    cycles = [math.ceil(r.iters / m) for r in solves]
    assert max(cycles) >= 2
    implied = sum(1 + c + r.iters for c, r in zip(cycles, solves)) \
        + stats.iters
    assert counted == implied


def test_spans_lie_in_a_profiler_trace_on_its_clock(profiled):
    """With spans on, each span of a step under a CPU `torch.profiler`
    session is an `ns.` user annotation inside the session's window,
    nested as the spans are, with the ops it ran inside it."""
    events, log, _, _, _, _ = profiled
    on = _inside(events, _spans(events, "on"), "user_annotation")
    snap = log.snapshot()
    for (name, _), (n, _, _) in snap.items():
        assert len([e for e in on if e["name"] == profiling.PREFIX + name]) \
            == sum(c for (nm, _), (c, _, _) in snap.items() if nm == name)
    steps = _spans(events, "ns.step")
    assert len(steps) == 1
    iters = _spans(events, "ns.gmres.iter")
    assert len(iters) == snap[("gmres.iter", "krylov.solve")][0]
    assert all(steps[0][0] <= s and e <= steps[0][1] for s, e in iters)
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "cpu_op"]
    applies = _spans(events, "ns.op.apply")
    assert applies and all(any(s <= a and b <= e for a, b in ops)
                           for s, e in applies)


def test_run_profile_prints_the_span_tree(capsys):
    """`--profile` on the f32 path: the run's phases at the root, every span
    of a 'tlp' run under them, indented by depth, and last the counters."""
    out = run.main(["--nx", "3", "--ny", "2", "--nz", "2", "--steps", "1",
                    "--device", "cpu", "--dtype", "float32", "--profile"])
    assert out.solver.prep_kind == "tlp" and profiling.active() is None
    text = capsys.readouterr().out
    tree = text[text.index("Span"):].splitlines()
    assert tree[0].split()[:2] == ["Span", "Count"]
    rows = {ln.strip().split()[0]: ln for ln in tree[1:]}
    assert {"setup", "stokes_init", "operator_prep", "time_loop"} <= set(rows)
    assert TLP_SPANS <= set(rows)
    assert rows["step"].startswith("  step")
    assert rows["time_loop"].split()[1] == "1"
    # then what the run added to the always-on counters (no graph on the
    # CPU)
    counted = dict(kv.split("=") for kv in tree[-1].split()[1:])
    assert tree[-1].startswith("Counters: ") and int(counted["syncs"]) > 0
    assert {k: counted[k] for k in ("graph_replays", "graph_ahead",
                                    "graph_discarded")} == dict.fromkeys(
        ("graph_replays", "graph_ahead", "graph_discarded"), "0")


# -- the pressure-Schur tier ---------------------------------------------------

def schur_cfg() -> NSConfig:
    """The 'sch' tier as 'auto' resolves it above 150k rows (a degree-2
    Chebyshev velocity smoother), forced on channel(3, 2, 2)."""
    return f32_cfg(preconditioner="schur", coarse_agg=4, schur_v_cheby=2)


@pytest.fixture(scope="module")
def schur_traced():
    """A 'sch' solver prepared, Stokes-initialized and stepped once with
    spans on: (solver, log snapshots after the Newton preparation, after
    Stokes and after the step, the step's state)."""
    log = profiling.enable()
    try:
        solver = NavierStokesSolver(MESH, schur_cfg(), device=CPU)
        solver._ensure_prepared()
        prepared = log.snapshot()
        u0 = solver.stokes_init()
        stokes = log.snapshot()
        u1, _, stats = solver.step(u0, u0, torch.zeros_like(u0))
    finally:
        profiling.disable()
    assert solver.prep_kind == "sch" and stats.converged
    return solver, prepared, stokes, log.snapshot(), (u0, u1)


def test_schur_set_up_spans_lie_under_the_operator_span(schur_traced):
    """`setup.schur` and a child per stage under `setup.operator`, once in
    the Newton preparation and once in the Stokes one."""
    _, prepared, stokes, _, _ = schur_traced
    for snap, n in ((prepared, 1), (stokes, 2)):
        assert snap[("setup.schur", "setup.operator")][0] == n
        assert {name for name, parent in snap
                if parent == "setup.schur"} == SCHUR_STAGES
        for stage in SCHUR_STAGES:
            assert snap[(stage, "setup.schur")][0] == n
    assert prepared[("setup.operator", "setup.prepare")][0] == 1
    assert ("setup.operator", "stokes") not in prepared
    assert stokes[("setup.operator", "stokes")][0] == 1


def test_schur_stage_seconds_are_the_spans_one_for_one(schur_traced):
    """`SchurPrep.seconds` holds one entry per stage span, under its name;
    each span lies inside its stage's seconds, and the stages inside
    `setup.schur` (the Newton preparation's, read before Stokes)."""
    solver, prepared, _, _, _ = schur_traced
    seconds = solver._exact_prep.seconds
    assert set(seconds) == SCHUR_STAGES
    for stage, s in seconds.items():
        assert 0 <= prepared[(stage, "setup.schur")][1] <= s
    assert sum(seconds.values()) <= \
        prepared[("setup.schur", "setup.operator")][1]


def test_schur_cycles_have_spans_inside_the_preconditioner(schur_traced):
    """`pc.fhat` and `pc.shat` under `pc.apply`, once each an apply (the
    'lower' shape), each with its coarse GEMV and smoother inside."""
    _, _, _, snap, _ = schur_traced
    applies = sum(n for (name, _), (n, _, _) in snap.items()
                  if name == "pc.apply")
    for cycle in ("pc.fhat", "pc.shat"):
        assert snap[(cycle, "pc.apply")][0] == applies > 0
        for child in ("pc.coarse", "pc.smooth"):
            assert snap[(child, cycle)][0] == applies
    assert ("pc.coarse", "pc.apply") not in snap


def test_schur_answers_are_the_same_with_spans_off(schur_traced):
    """Stokes and one step with spans off equal the traced ones bit for
    bit."""
    solver, _, _, _, (u0_on, u1_on) = schur_traced
    assert profiling.active() is None
    off = NavierStokesSolver(MESH, schur_cfg(), disc=solver.disc,
                             device=CPU)
    u0 = off.stokes_init()
    u1, _, _ = off.step(u0, u0, torch.zeros_like(u0))
    assert torch.equal(u0, u0_on) and torch.equal(u1, u1_on)
