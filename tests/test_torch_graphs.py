"""GMRES's inner iterations as CUDA graphs (`solvers/graphs.py`) and the
held closures of the exact-Jacobian prep (`model/navier_stokes.py`).

On the CPU: the rule that engages the graphs, the launch-counter and
graph-counter bookkeeping of capture and replay, and that the held
closures and the persistent basis leave answers bit for bit as before.
Capture there goes through `StandIn`, which records by running the
iteration (as a capture passes through the launch wrappers), replays
by running it with the launch counters left as they were (a replay does
not pass through them) and copies a column out at once (on the card the
copy is ordered before the next replay on the stream), logging replays
and reads in order.  On the card (`cuda` marker): graphed against eager,
bit for bit, on 'tlp' at matrix 6 (GMRES solves that restart, converge
early and break down, and Newton steps with their launch counts: the
eager step's plus the discarded replays') and on 'tl', 'sch' and 'bj' on
a small mesh; and on 'sch' at matrix 9, the deployment the benchmark's
Schur cell runs."""

import dataclasses

import numpy as np
import pytest
import torch

from navierstokes_tpu_torch import run
from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu_torch.mesh import channel_mesh
from navierstokes_tpu_torch.mesh.box import scaling_series_mesh
from navierstokes_tpu_torch.model import NavierStokesSolver
from navierstokes_tpu_torch.ops import dia as tdia
from navierstokes_tpu_torch.ops import plane_dia as tpd
from navierstokes_tpu_torch.parallel import DistributedNavierStokesSolver
from navierstokes_tpu_torch.solvers import graphs
from navierstokes_tpu_torch.solvers import vectors as vs
from navierstokes_tpu_torch.solvers.gmres import gmres
from navierstokes_tpu_torch.utils import profiling

torch.set_num_threads(1)
CPU = torch.device("cpu")
MESH = channel_mesh(3, 2, 2)


class StandIn:
    """A recorder for the CPU: warm-up and capture run the iteration; a
    replay runs it again with the launch counters left as they were; a
    column's copy out happens at once, its read at the wait.  `log` holds
    ("replay", k) and ("read", k) in the order they happen."""

    def __init__(self, device=None):
        self.recorded = 0
        self.log = []

    def warm_up(self, fn):
        fn()

    def record(self, fn):
        fn()
        self.recorded += 1
        log, k = self.log, fn.args[0]

        class Graph:
            def replay(self):
                log.append(("replay", k))
                before = graphs.launch_counts()
                fn()
                graphs.restore_launches(before)
        return Graph()

    def copy_out(self, src, dst):
        dst.copy_(src)
        log, k = self.log, src.numel() - 2

        class Copied:
            def synchronize(self):
                log.append(("read", k))
        return Copied()


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs engage on CPU tensors (never on shards), captured by
    `StandIn`."""
    monkeypatch.setattr(graphs, "capturable",
                        lambda b: isinstance(b, torch.Tensor))
    monkeypatch.setattr(graphs, "CudaRecorder", StandIn)


def f32_cfg(**krylov) -> NSConfig:
    """The CLI's float32 config ('tlp' at this size), with `krylov` on both
    Krylov configs."""
    kr = dataclasses.replace(run.default_f32_krylov(), **krylov)
    return NSConfig(dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
                    newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                                        du_tol=float("inf")),
                    krylov=kr, stokes_krylov=kr)


@pytest.fixture(scope="module")
def tlp():
    """A 'tlp' solver on channel(3, 2, 2), Stokes-initialized and stepped
    once eagerly: (solver, u0, the step's (u, delta_u, stats))."""
    solver = NavierStokesSolver(MESH, f32_cfg(), device=CPU)
    u0 = solver.stokes_init()
    out = solver.step(u0, u0, torch.zeros_like(u0))
    assert solver.prep_kind == "tlp" and out[2].converged
    return solver, u0, out


def _counts() -> tuple:
    return profiling.graph_captures, profiling.graph_replays


def _ahead() -> tuple:
    return profiling.graph_ahead, profiling.graph_discarded


# -- the rule --------------------------------------------------------------

@pytest.mark.parametrize("change, held, engaged", [
    ({}, True, True),
    ({}, False, False),
    ({"method": "cg"}, True, False),
    ({"method": "ca_gmres"}, True, False),
    ({"cgs2": "pallas"}, True, False),
    ({"cgs2": "pallas_comp"}, True, False),
], ids=["gmres-held", "not-held", "cg", "ca_gmres", "k3", "k3-comp"])
def test_rule_takes_plain_gmres_of_a_held_operator(monkeypatch, change, held,
                                                   engaged):
    monkeypatch.setattr(graphs, "capturable", lambda b: True)
    cfg = dataclasses.replace(SolverConfig(), **change)
    assert graphs.engages(cfg, held, torch.zeros(4)) is engaged


def test_rule_never_takes_the_cpu_or_shards():
    b = torch.zeros(8)
    assert not graphs.capturable(b)
    assert not graphs.capturable(vs.Shards([b[:4], b[4:]]))
    assert not graphs.engages(SolverConfig(), True, b)


@pytest.mark.parametrize("jacobian, krylov", [
    ("reference", {}),
    ("exact", {"deflation_k": 4}),
    ("exact", {"method": "ca_gmres"}),
    ("exact", {"method": "cg"}),
    ("exact", {"cgs2": "pallas"}),
], ids=["reference", "deflated", "ca_gmres", "cg", "k3"])
def test_solves_off_the_rule_stay_eager(tlp, stand_in, jacobian, krylov):
    """Reference mode (a new prep every iteration), the deflated prep,
    CA-GMRES, CG and K3's CGS2: a Newton solve (at most 40 Krylov
    iterations) captures nothing, even where the vectors could be
    captured."""
    solver, u0, _ = tlp
    cfg = dataclasses.replace(f32_cfg(maxiter=40, **krylov),
                              jacobian=jacobian,
                              newton=NewtonConfig(max_iter=2))
    other = NavierStokesSolver(MESH, cfg, disc=solver.disc, device=CPU)
    other._ensure_prepared()
    before = _counts()
    _, _, stats = other.step(u0, u0, torch.zeros_like(u0))
    assert stats.lin_iters > 0 and _counts() == before


def test_stokes_stays_eager_and_newton_is_graphed(tlp, stand_in):
    """The Stokes solve (a prep of its own) captures nothing; a step's
    Newton solves of the held prep capture each basis index once and
    replay after, with the answers of the eager step bit for bit; each
    inner iteration is a capture or a replay, and each replay past a
    cycle's end is discarded."""
    solver, u0, (u, du, stats) = tlp
    before, ahead = _counts(), _ahead()
    other = NavierStokesSolver(MESH, f32_cfg(), disc=solver.disc, device=CPU)
    assert torch.equal(other.stokes_init(), u0)
    assert _counts() == before and _ahead() == ahead
    for first in (True, False):
        u2, du2, stats2 = other.step(u0, u0, torch.zeros_like(u0))
        assert torch.equal(u2, u) and torch.equal(du2, du)
        assert stats2.lin_iters == stats.lin_iters
        assert np.array_equal(stats2.res_hist, stats.res_hist,
                              equal_nan=True)
        captures, replays = (a - b for a, b in zip(_counts(), before))
        n_ahead, discarded = (a - b for a, b in zip(_ahead(), ahead))
        assert 0 < captures <= 30 if first else captures == 0
        assert captures + replays - discarded == stats.lin_iters
        assert discarded <= n_ahead <= replays
        assert n_ahead > 0 if not first else True
        before, ahead = _counts(), _ahead()


def test_shards_stay_eager(stand_in):
    """The distributed solver's solves (shards) capture nothing."""
    cfg = f32_cfg(preconditioner="two_level", coarse_agg=2)
    solver, _ = DistributedNavierStokesSolver.from_mesh(
        channel_mesh(12, 2, 2), cfg, devices=["cpu"] * 2)
    u0 = torch.zeros(4 * solver.disc.nv)
    before = _counts()
    _, _, stats = solver.step(u0, u0, torch.zeros_like(u0))
    assert stats.lin_iters > 0 and _counts() == before


# -- the held closures and the persistent basis -----------------------------

def test_held_closures_are_built_once_and_again_when_spans_turn(tlp):
    solver = tlp[0]
    prep = solver._exact_prep
    first = solver._operators(prep)
    assert solver._operators(prep)[:2] == first[:2] and first[2] is not None
    profiling.enable()
    try:
        spanned = solver._operators(prep)
    finally:
        profiling.disable()
    assert spanned[0] is not first[0] and spanned[2].graphs is first[2].graphs
    assert solver._operators(prep)[0] is not spanned[0]
    stokes = solver._prepare_operator_dia(solver._stokes_dia())
    assert solver._operators(stokes)[2] is None


def test_held_closures_leave_answers_as_built_anew(tlp, monkeypatch):
    """A step with the held closures equals, bit for bit, one whose
    closures are built anew for every solve (as before they were held)."""
    solver, u0, (u, du, stats) = tlp

    def anew(prep):
        matvec, b_prep, _ = solver._prep_operators(prep)
        return matvec, b_prep, None

    monkeypatch.setattr(solver, "_operators", anew)
    u2, du2, stats2 = solver.step(u0, u0, torch.zeros_like(u0))
    assert torch.equal(u2, u) and torch.equal(du2, du)
    assert stats2.lin_iters == stats.lin_iters


# -- gmres with graphs, and the launch counters -----------------------------

def _system(n: int = 48, seed: int = 3):
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(np.eye(n) * 4 + rng.standard_normal((n, n)) / n,
                        dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    return A, b


def _counted(A):
    """A matvec that counts as one tiled 4x4 K1 launch and two K2 launches
    would."""
    form = ("4x4", 15, "tiled")

    def matvec(x):
        tpd.kernel_launches += 1
        tpd.route_launches["tiled"] += 1
        tpd.form_launches[form] = tpd.form_launches.get(form, 0) + 1
        tdia.kernel_launches += 2
        return A @ x
    return matvec


@pytest.mark.parametrize("restart, rtol", [(4, 1e-6), (30, 1e-3)],
                         ids=["restarts", "converges-early"])
def test_graphed_gmres_counts_as_eager(restart, rtol):
    """Two solves with the same graphs: each basis index captured once
    (the warm-up's launches counted, the capture's not), every later
    iteration a replay adding its capture's launches, a discarded replay
    too; the answers equal the eager solves', and the launch counters
    the eager solves' plus one iteration's launches per discarded
    replay."""
    A, b = _system()
    matvec = _counted(A)
    kw = dict(restart=restart, rtol=rtol, atol=0.0, maxiter=200)
    start = graphs.launch_counts()
    eager = [gmres(matvec, b, **kw) for _ in range(2)]
    eager_counts = graphs.restore_launches(start)
    g = graphs.IterationGraphs(b, restart, recorder=StandIn())
    before, ahead = _counts(), _ahead()
    graphed = [gmres(matvec, b, graphs=g, **kw) for _ in range(2)]
    graphed_counts = graphs.restore_launches(start)
    for e, r in zip(eager, graphed):
        assert torch.equal(e.x, r.x) and e.iters == r.iters
        assert e.resnorm == r.resnorm and e.converged and r.converged
    discarded = _ahead()[1] - ahead[1]
    one = {(tpd, "kernel_launches", None): 1, (tpd, "route_launches",
           "tiled"): 1, (tpd, "form_launches", ("4x4", 15, "tiled")): 1,
           (tdia, "kernel_launches", None): 2}
    assert graphed_counts == {key: n + discarded * one.get(key, 0)
                              for key, n in eager_counts.items()}
    assert eager_counts[tpd, "kernel_launches", None] > 2 * eager[0].iters
    captured = min(restart, eager[0].iters)
    assert _counts()[0] - before[0] == captured == g._recorder.recorded
    assert (_counts()[1] - before[1]
            == 2 * eager[0].iters - captured + discarded)
    # where a solve restarts, every index is captured in its first cycle,
    # so both solves' last cycle (5 = 4 + 1) discards graph 1's replay; a
    # solve of one cycle captures no index past its end
    assert discarded == (2 if eager[0].iters > restart else 0)


@pytest.mark.parametrize("restart, rtol", [(4, 1e-6), (30, 1e-3)],
                         ids=["restarts", "converges-early"])
def test_graph_k1_replays_before_column_k_is_read(restart, rtol):
    """A solve whose graphs are captured (by a solve to a tighter rtol): in
    each cycle graph 0 is replayed, then for each k graph k+1 (below
    `restart`) before column k is read; the replay past the last cycle,
    which ends before `restart`, is discarded.  `graph_ahead`,
    `graph_discarded` and the host waits (one per iteration, as eager)
    follow from the shape: n iterations in c cycles, the last of l."""
    A, b = _system()
    matvec = _counted(A)
    kw = dict(restart=restart, rtol=rtol, atol=0.0, maxiter=200)
    syncs = profiling.syncs
    n = gmres(matvec, b, **kw).iters
    eager_syncs = profiling.syncs - syncs
    g = graphs.IterationGraphs(b, restart, recorder=StandIn())
    assert gmres(matvec, b, graphs=g, **{**kw, "rtol": 1e-6}).iters == 5
    g._recorder.log.clear()
    before, ahead, syncs = _counts(), _ahead(), profiling.syncs
    assert gmres(matvec, b, graphs=g, **kw).iters == n
    c = -(-n // restart)
    last = n - (c - 1) * restart
    assert (n, c, last) == ((5, 2, 1) if restart == 4 else (3, 1, 3))
    order = []
    for length in [restart] * (c - 1) + [last]:
        order.append(("replay", 0))
        for k in range(length):
            order += [("replay", k + 1)] * (k + 1 < restart)
            order.append(("read", k))
    assert g._recorder.log == order
    assert _counts()[0] == before[0]
    assert _counts()[1] - before[1] == n + 1
    assert (_ahead()[0] - ahead[0], _ahead()[1] - ahead[1]) == (n + 1 - c, 1)
    assert profiling.syncs - syncs == eager_syncs == 1 + c + n


def _singular(n: int, device=CPU):
    """diag(0, 1, 0, 1, ...) and b = ones, n a power of 4 (every basis
    entry and inner product a power of two, exact): b leaves the range,
    and the Krylov space ends at k = 1 with ||w|| and the rotated R[1, 1]
    exactly 0, a hard breakdown."""
    d = torch.tensor([0.0, 1.0], device=device).repeat(n // 2)
    return (lambda x: d * x), torch.ones(n, device=device)


def test_graphed_gmres_breaks_down_as_eager():
    matvec, b = _singular(64)
    kw = dict(restart=10, rtol=1e-12, atol=0.0, maxiter=50)
    e = gmres(matvec, b, **kw)
    g = graphs.IterationGraphs(b, 10, recorder=StandIn())
    for _ in range(2):
        r = gmres(matvec, b, graphs=g, **kw)
        assert e.iters == r.iters == 1 and not e.converged
        assert not r.converged
        assert torch.equal(e.x, r.x) and e.resnorm == r.resnorm


def test_restore_launches_drops_keys_new_since():
    start = graphs.launch_counts()
    key = ("test-form", 1, "rows")
    tpd.form_launches[key] = 3
    tpd.kernel_launches += 3
    delta = graphs.restore_launches(start)
    assert delta == {(tpd, "form_launches", key): 3,
                     (tpd, "kernel_launches", None): 3}
    assert key not in tpd.form_launches and graphs.launch_counts() == start
    graphs.add_launches(delta)
    assert tpd.form_launches.pop(key) == 3
    tpd.kernel_launches -= 3


def test_graphs_refuse_k3_and_other_shapes():
    A, b = _system()
    g = graphs.IterationGraphs(b, 4, recorder=StandIn())
    for kw in ({"cgs2_kernel": True}, {"restart": 5}):
        with pytest.raises(ValueError, match="iteration graphs"):
            gmres(_counted(A), b, graphs=g, **{"restart": 4, **kw})
    with pytest.raises(ValueError, match="iteration graphs"):
        gmres(_counted(A), torch.zeros(7), graphs=g, restart=4)


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


def _eager(monkeypatch):
    monkeypatch.setattr(graphs, "capturable", lambda b: False)


@pytest.fixture(scope="module")
def m6():
    """The f32 flagship at matrix 6 on the card, prepared, with its Stokes
    state."""
    dev = _card()
    solver = NavierStokesSolver(scaling_series_mesh(6), f32_cfg(),
                                device=dev)
    u0 = solver.stokes_init()
    solver._ensure_prepared()
    assert solver.prep_kind == "tlp"
    return solver, u0


@pytest.mark.cuda
@pytest.mark.parametrize("rtol", [1e-7, 1e-2], ids=["restarts", "early"])
def test_graphed_gmres_equals_eager_on_the_card(m6, rtol):
    """GMRES on the held 'tlp' operator at matrix 6, graphed (captured in
    the first solve, replayed in the second) and eager: x, the iteration
    count and the residual estimate equal bit for bit.  rtol 1e-7 runs
    past k = 30 (restarts), 1e-2 ends below it."""
    solver, u0 = m6
    matvec, b_prep, _ = solver._operators(solver._exact_prep)
    F = solver._residual_fn(u0)(u0)
    b = b_prep(tpd.to_planes(-F, solver.disc.nv, solver._nbp))
    kw = dict(restart=30, rtol=rtol, atol=0.0, maxiter=300)
    eager = gmres(matvec, b, **kw)
    g = graphs.IterationGraphs(b, 30)
    graphed = [gmres(matvec, b, graphs=g, **kw) for _ in range(2)]
    assert eager.iters > 30 if rtol == 1e-7 else eager.iters < 30
    for r in graphed:
        assert torch.equal(r.x, eager.x) and r.iters == eager.iters
        assert r.resnorm == eager.resnorm and r.converged == eager.converged


@pytest.mark.cuda
def test_graphed_gmres_breaks_down_as_eager_on_the_card():
    """The hard breakdown at k = 1 on the card, captured and replayed, as
    it runs eagerly."""
    matvec, b = _singular(4 ** 7, _card())
    kw = dict(restart=10, rtol=1e-12, atol=0.0, maxiter=50)
    e = gmres(matvec, b, **kw)
    g = graphs.IterationGraphs(b, 10)
    for _ in range(2):
        r = gmres(matvec, b, graphs=g, **kw)
        assert e.iters == r.iters == 1 and not r.converged
        assert torch.equal(e.x, r.x) and e.resnorm == r.resnorm


def _steps_both_ways(solver, u0, monkeypatch, steps: int = 2) -> tuple:
    """`steps` steps graphed (after the same steps once, which capture),
    then eagerly: ((u, delta_u, [(Newton, GMRES)], launch counts, graph
    counts, ahead and discarded counts) graphed, and eager), and the
    graphed steps' discarded replays' launch counts (one dict each)."""

    def run_steps():
        u, du = u0, torch.zeros_like(u0)
        hist = []
        for _ in range(steps):
            u_new, du, st = solver.step(u, u, du)
            u = u_new
            hist.append((st.iters, st.lin_iters))
        return u, du, hist

    run_steps()
    discarded = []
    end_cycle = graphs.IterationGraphs.end_cycle

    def spy(g):
        if g._ahead is not None:
            discarded.append(g._launches[g._ahead])
        end_cycle(g)

    out = []
    for graphed in (True, False):
        if graphed:
            monkeypatch.setattr(graphs.IterationGraphs, "end_cycle", spy)
        else:
            _eager(monkeypatch)
        before = graphs.launch_counts()
        graph_counts, ahead = _counts(), _ahead()
        u, du, hist = run_steps()
        torch.cuda.synchronize()
        counts = {k: v - before.get(k, 0)
                  for k, v in graphs.launch_counts().items()}
        out.append((u, du, hist, {k: v for k, v in counts.items() if v},
                    tuple(a - b for a, b in zip(_counts() + _ahead(),
                                                graph_counts + ahead))))
        if graphed:
            assert out[0][4][3] == len(discarded)
    return out + [discarded]


def _plus(counts: dict, extra: list) -> dict:
    """`counts` with every dict of `extra` added."""
    out = dict(counts)
    for more in extra:
        for key, n in more.items():
            out[key] = out.get(key, 0) + n
    return out


@pytest.mark.cuda
def test_graphed_newton_steps_equal_eager_on_the_card(m6, monkeypatch):
    """Two 'tlp' steps at matrix 6 graphed, with the run-ahead, and eager:
    states, Newton and GMRES counts equal bit for bit; every graphed inner
    iteration a capture or a replay, none of the eager ones; one replay
    discarded per solve (Newton 2 is the start check and one solve) whose
    last cycle ends at a length l < 30 with graph l captured, and the
    launch counters the eager steps' plus the discarded replays'."""
    solver, u0 = m6
    (ug, dg, hg, cg, ng), (ue, de, he, ce, ne), extra = _steps_both_ways(
        solver, u0, monkeypatch)
    assert torch.equal(ug, ue) and torch.equal(dg, de) and hg == he
    assert cg == _plus(ce, extra) and cg[tpd, "kernel_launches", None] > 0
    captures, replays, ahead, discarded = ng
    assert all(h[0] == 2 for h in hg) and captures == 0
    held = solver._held.graphs
    ends = [h[1] % 30 for h in hg]      # each solve's last cycle; 0: full
    assert discarded == len(extra) == sum(
        1 for end in ends if end and held._graphs[end] is not None) > 0
    assert captures + replays - discarded == sum(h[1] for h in hg)
    assert replays > ahead > 0 and ne == (0, 0, 0, 0)
    assert held._host.is_pinned()


@pytest.mark.cuda
@pytest.mark.parametrize("krylov", [
    dict(preconditioner="two_level", spmv="pallas", coarse_cheby=3),
    dict(preconditioner="schur", spmv="plane", coarse_agg=8),
    dict(preconditioner="block_jacobi", spmv="pallas", neumann_order=2),
], ids=["tl", "sch", "bj"])
def test_graphed_tiers_equal_eager_on_the_card(krylov, monkeypatch):
    """'tl' (K2), 'sch' (K1 on its sub-blocks) and 'bj' (K2) on
    channel(12, 6, 6): two steps graphed and eager equal bit for bit, with
    the eager steps' launch counts plus the discarded replays'."""
    dev = _card()
    solver = NavierStokesSolver(channel_mesh(12, 6, 6, obstacle=True),
                                f32_cfg(**krylov), device=dev)
    u0 = solver.stokes_init()
    assert solver.prep_kind == {"two_level": "tl", "schur": "sch",
                                "block_jacobi": "bj"}[
        krylov["preconditioner"]]
    (ug, dg, hg, cg, ng), (ue, de, he, ce, _), extra = _steps_both_ways(
        solver, u0, monkeypatch)
    assert torch.equal(ug, ue) and torch.equal(dg, de) and hg == he
    assert cg == _plus(ce, extra) and ng[1] > 0


@pytest.mark.cuda
def test_graphed_schur_step_equals_eager_at_matrix_9_on_the_card(
        monkeypatch):
    """Matrix 9 (998,784 DoF) as `run.py --matrix-id 9` builds it, 'auto'
    resolving to 'sch': after a step that captures, a step graphed and
    the same step eager equal bit for bit, with the same Newton and GMRES
    counts, and launch counts the eager step's plus the discarded
    replays'; every graphed inner iteration replays, none captures."""
    dev = _card()
    solver = NavierStokesSolver(scaling_series_mesh(9), f32_cfg(),
                                device=dev)
    u0 = solver.stokes_init()
    assert solver.prep_kind == "sch"
    captures = profiling.graph_captures
    (ug, dg, hg, cg, ng), (ue, de, he, ce, ne), extra = _steps_both_ways(
        solver, u0, monkeypatch, steps=1)
    assert torch.equal(ug, ue) and torch.equal(dg, de) and hg == he
    assert cg == _plus(ce, extra) and ne == (0, 0, 0, 0)
    # the first step's first solve passes k = 29: it captures all 30
    assert ng[:2] == (0, hg[0][1] + len(extra))
    assert profiling.graph_captures - captures == 30
