"""GMRES's inner iterations as CUDA graphs, one per basis index.

The device part of inner iteration k (`gmres.arnoldi_step`: w =
M(matvec(V[k])), CGS2 against V[:k+1], ||w||, V[k+1] = w / ||w||, and the
Hessenberg column [h, ||w||] into a static buffer) launches ~45 kernels
one by one from Python, each costing the host more than the device.
`IterationGraphs` captures it once per k, the first time iteration k is
reached, and replays it on every later iteration k: the host then pays
one graph launch where it paid every kernel's.  The GEMV shapes differ
with k, so one graph per k replays exactly the kernels and launch
configurations the eager loop runs, and the answers are the same bit for
bit.  The host keeps the rest: the column's fetch, the Givens rotations,
the tests, the back-substitution, the restart residual and x's update.

Capture follows `torch.cuda.graph`'s recipe: the iteration runs once on a
side stream (the warm-up, whose results are the iteration's: nothing is
run twice), then is captured on that stream.  All of one held solve's
graphs share one memory pool: they replay one after another on one
stream, and every output lands in a buffer that outlives them (the basis
`V`, the column `col`).  Counters stay true: each replay adds to the
kernels' launch counters (`ops/plane_dia`, `ops/dia`, `ops/cgs2`,
`ops/mpk_fused`) what its capture launched, and `utils/profiling` counts
`graph_captures` and `graph_replays`; span `gmres.replay` times each
replay.

Where the graphs engage (`engages`): a plain GMRES solve (`method`
'gmres', `cgs2` 'xla') of an operator the solver holds and solves again
and again (its exact-Jacobian prep), with the right-hand side one tensor
on a CUDA device.  K3 and K4 share one grid-barrier word across launches
(`csrc/grid_sync.cuh`), so `cgs2` 'pallas' and 'pallas_comp' stay eager.
"""

from __future__ import annotations

import functools

import torch

from navierstokes_tpu_torch.ops import cgs2, dia, mpk_fused, plane_dia
from navierstokes_tpu_torch.solvers import vectors as vs
from navierstokes_tpu_torch.solvers.gmres import arnoldi_step
from navierstokes_tpu_torch.utils import profiling

# the kernels' launch counters: plain integers and dicts of them
_COUNTED = (plane_dia, dia, cgs2, mpk_fused)
_TOTALS = ("kernel_launches", "halo_launches")
_BY_KEY = ("route_launches", "form_launches")


def launch_counts() -> dict:
    """Every kernel launch counter now: {(module, counter, key or None):
    count}."""
    out = {}
    for mod in _COUNTED:
        for name in _TOTALS:
            if hasattr(mod, name):
                out[mod, name, None] = getattr(mod, name)
        for name in _BY_KEY:
            for key, n in getattr(mod, name, {}).items():
                out[mod, name, key] = n
    return out


def add_launches(counts: dict) -> None:
    """Add `counts` ({(module, counter, key or None): n}) to the
    counters."""
    for (mod, name, key), n in counts.items():
        if key is None:
            setattr(mod, name, getattr(mod, name) + n)
        else:
            table = getattr(mod, name)
            table[key] = table.get(key, 0) + n


def restore_launches(before: dict) -> dict:
    """Set the counters back to the snapshot `before`; returns what they
    had counted since (a key new since then is dropped)."""
    delta = {}
    for (mod, name, key), n in launch_counts().items():
        moved = n - before.get((mod, name, key), 0)
        if not moved:
            continue
        delta[mod, name, key] = moved
        if key is None:
            setattr(mod, name, n - moved)
        elif (mod, name, key) in before:
            getattr(mod, name)[key] = n - moved
        else:
            del getattr(mod, name)[key]
    return delta


def capturable(b) -> bool:
    """Whether a solve's vectors can be captured: one tensor on a CUDA
    device (never shards, never the CPU)."""
    return isinstance(b, torch.Tensor) and b.device.type == "cuda"


def engages(solver_cfg, held: bool, b) -> bool:
    """The rule: graphs for a plain GMRES solve with the four-GEMV CGS2 of
    a held operator, on one CUDA tensor."""
    return (held and solver_cfg.method == "gmres"
            and solver_cfg.cgs2 == "xla" and capturable(b))


class CudaRecorder:
    """Warm-up and capture on one side stream of the vectors' device, into
    one memory pool."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm_up(self, fn) -> None:
        """Run `fn` on the side stream, ordered after the current stream's
        work and before its next."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    def record(self, fn) -> torch.cuda.CUDAGraph:
        """Capture what `fn` launches (it runs nothing) into a graph."""
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                fn()
            finally:
                graph.capture_end()
        return graph


class IterationGraphs:
    """The persistent Krylov basis `V` (restart + 1 rows), the column buffer
    and one captured graph per basis index k of a held GMRES solve; pass
    to `gmres(..., graphs=)`.  `recorder` warms up and captures (a
    `CudaRecorder` of b's device by default)."""

    def __init__(self, b: torch.Tensor, restart: int, recorder=None):
        self.restart = restart
        self.V = vs.basis(restart + 1, b)
        self.col = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
        self.one = torch.ones((), dtype=b.dtype, device=b.device)
        self._recorder = recorder or CudaRecorder(b.device)
        self._graphs = [None] * restart
        self._launches = [None] * restart     # each graph's launch counts

    def fits(self, b: torch.Tensor, restart: int) -> bool:
        """Whether these buffers serve a solve of b with `restart`."""
        return (restart == self.restart and b.shape == self.V.shape[1:]
                and b.dtype == self.V.dtype and b.device == self.V.device)

    def _device_part(self, k: int, matvec, precond) -> None:
        h_t, hk1_t = arnoldi_step(matvec, precond, self.V, k, self.one)
        torch.cat([h_t, hk1_t[None]], out=self.col[:k + 2])

    def column(self, k: int, matvec, precond) -> torch.Tensor:
        """Run the device part of inner iteration k: the first time by the
        warm-up, then captured; after that by a replay.  Returns the
        column [h_0..h_k, ||w||] on the device."""
        graph = self._graphs[k]
        if graph is None:
            fn = functools.partial(self._device_part, k, matvec, precond)
            self._recorder.warm_up(fn)
            before = launch_counts()
            self._graphs[k] = self._recorder.record(fn)
            # the capture ran nothing: its launches count at each replay
            self._launches[k] = restore_launches(before)
            profiling.graph_captures += 1
        else:
            with profiling.span("gmres.replay"):
                graph.replay()
            add_launches(self._launches[k])
            profiling.graph_replays += 1
        return self.col[:k + 2]
