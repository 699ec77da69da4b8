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
bit.  The host keeps the rest: the column's read, the Givens rotations,
the tests, the back-substitution, the restart residual and x's update.

The host's read of column k trails the device by one iteration
(`IterationGraphs.column`): graph k+1 needs nothing the host computes from
column k (it reads `V[k+1]`, which graph k wrote), so once column k's copy
to pinned host memory and an event after it are enqueued, graph k+1 is
replayed, and only then does the host wait, on that event alone.  The
device runs iteration k+1 while the host rotates column k.  Where the
cycle ends at k, the replay launched ahead is discarded (`end_cycle`): it
wrote only `V[k+2]` and the column buffer, which nothing reads before the
next cycle's `V.zero_()`, ordered after it on the same stream, so every
number the solve returns is the in-order loop's bit for bit.  Where graph
k+1 is not captured yet, iteration k runs in order.

Capture follows `torch.cuda.graph`'s recipe: the iteration runs once on a
side stream (the warm-up, whose results are the iteration's: nothing is
run twice), then is captured on that stream.  All of one held solve's
graphs share one memory pool: they replay one after another on one
stream, and every output lands in a buffer that outlives them (the basis
`V`, the column `col`).  Counters stay true: each replay adds to the
kernels' launch counters (`ops/plane_dia`, `ops/dia`, `ops/cgs2`,
`ops/mpk_fused`) what its capture launched, a discarded one too (the
device ran it), and `utils/profiling` counts `graph_captures`,
`graph_replays`, `graph_ahead` (replays launched before the previous
column was read) and `graph_discarded`; span `gmres.replay` times each
replay.

Where the graphs engage (`engages`): a plain GMRES solve (`method`
'gmres', `cgs2` 'xla') of an operator the solver holds and solves again
and again (its exact-Jacobian prep), with the right-hand side one tensor
on a CUDA device.  K3 and K4 share one grid-barrier word across launches
(`csrc/grid_sync.cuh`), so `cgs2` 'pallas' and 'pallas_comp' stay eager.
"""

from __future__ import annotations

import functools

import numpy as np
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
        # one event serves every copy: the host waits on each before the
        # next copy is enqueued
        self.copied = torch.cuda.Event()

    def warm_up(self, fn) -> None:
        """Run `fn` on the side stream, ordered after the current stream's
        work and before its next."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    def copy_out(self, src: torch.Tensor, dst: torch.Tensor):
        """Enqueue `dst.copy_(src)` (dst in pinned host memory) on the
        current stream; returns an event recorded after it, for
        `profiling.wait`."""
        dst.copy_(src, non_blocking=True)
        self.copied.record(torch.cuda.current_stream(self.device))
        return self.copied

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
    to `gmres(..., graphs=)`.  `recorder` warms up, captures and copies
    columns out (a `CudaRecorder` of b's device by default)."""

    def __init__(self, b: torch.Tensor, restart: int, recorder=None):
        self.restart = restart
        self.V = vs.basis(restart + 1, b)
        self.col = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
        # row k: column k on the host
        self._host = torch.zeros((restart, restart + 1), dtype=b.dtype,
                                 pin_memory=b.device.type == "cuda")
        self.one = torch.ones((), dtype=b.dtype, device=b.device)
        self._recorder = recorder or CudaRecorder(b.device)
        self._graphs = [None] * restart
        self._launches = [None] * restart     # each graph's launch counts
        self._ahead = None      # the index whose replay is in flight unread

    def fits(self, b: torch.Tensor, restart: int) -> bool:
        """Whether these buffers serve a solve of b with `restart`."""
        return (restart == self.restart and b.shape == self.V.shape[1:]
                and b.dtype == self.V.dtype and b.device == self.V.device)

    def _device_part(self, k: int, matvec, precond) -> None:
        h_t, hk1_t = arnoldi_step(matvec, precond, self.V, k, self.one)
        torch.cat([h_t, hk1_t[None]], out=self.col[:k + 2])

    def _replay(self, k: int) -> None:
        with profiling.span("gmres.replay"):
            self._graphs[k].replay()
        add_launches(self._launches[k])
        profiling.graph_replays += 1

    def column(self, k: int, matvec, precond) -> np.ndarray:
        """Inner iteration k's column [h_0..h_k, ||w||] on the host.  Its
        device part runs unless iteration k-1 launched it ahead: the first
        time by the warm-up, then captured; after that by a replay.  Before
        the host waits for the column, graph k+1 is replayed where it is
        captured and k+1 < restart."""
        if self._ahead != k:
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
                self._replay(k)
        row = self._host[k, :k + 2]
        copied = self._recorder.copy_out(self.col[:k + 2], row)
        self._ahead = None
        if k + 1 < self.restart and self._graphs[k + 1] is not None:
            self._replay(k + 1)
            profiling.graph_ahead += 1
            self._ahead = k + 1
        profiling.wait(copied)
        return row.numpy()

    def end_cycle(self) -> None:
        """The cycle ends: a replay launched ahead is discarded."""
        if self._ahead is not None:
            profiling.graph_discarded += 1
            self._ahead = None
