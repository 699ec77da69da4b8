"""The program's spans and its count of host-device waits.

- `EventLog`: the one span store.  Per span name and parent span it keeps
  the count, the total host seconds and the self seconds (total less the
  part its child spans cover), in memory; `report()` prints the tree.
- `enable()` / `disable()`: spans are off by default.  `python -m
  navierstokes_tpu_torch.run --profile` and `python3 -m benchmark.spans`
  turn them on.  Off, a span site costs one test of a module flag, and a
  closure built per solve (`wrap`) is the bare closure.
- While a `torch.profiler` session records, each span also opens
  `record_function("ns.<name>")`, so it lies in the Chrome trace as a
  `user_annotation` on the clock of the kernels and runtime calls.
- `fetch(t)`: every device-to-host read on the solve path goes through it,
  or through `wait(event)` where the read was enqueued as a copy to pinned
  host memory (a graphed GMRES iteration's column).  Either counts the
  wait in `syncs` (always, as the kernels' launch counters count) and,
  with spans on, times it as span `sync`.
- Always on, for the CUDA graphs of GMRES's inner iteration
  (`solvers/graphs.py`): `graph_captures` and `graph_replays` count the
  graphs captured and replayed; `graph_ahead` the replays launched before
  the previous iteration's column was read, and `graph_discarded` those
  whose column was never read (the cycle ended first).  `graph_ahead /
  graph_replays` is the share of replays that ran ahead of the host.
- `counters()`: all of these at once; `python -m navierstokes_tpu_torch.run
  --profile` prints what a run added to them after the span tree.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Optional

import torch

PREFIX = "ns."          # the spans' names in a profiler trace

_on = False
_log: Optional["EventLog"] = None
syncs = 0               # host waits on the device: `fetch`, `wait`
graph_captures = 0      # CUDA graphs captured (solvers/graphs.py)
graph_replays = 0       # and replayed
graph_ahead = 0         # replays launched before the last column was read
graph_discarded = 0     # replays whose column was never read
COUNTERS = ("syncs", "graph_captures", "graph_replays", "graph_ahead",
            "graph_discarded")
_OFF = contextlib.nullcontext()


class EventLog:
    """Spans by path (the names from the outermost open span down): count,
    total and child seconds; read by (name, parent) or as a tree."""

    def __init__(self):
        self._count = defaultdict(int)
        self._total = defaultdict(float)
        self._inner = defaultdict(float)
        self._open = []         # [path, start, child seconds] per open span

    def enter(self, name: str) -> None:
        path = (self._open[-1][0] if self._open else ()) + (name,)
        self._open.append([path, time.perf_counter(), 0.0])

    def exit(self) -> None:
        path, t0, inner = self._open.pop()
        dt = time.perf_counter() - t0
        self._count[path] += 1
        self._total[path] += dt
        self._inner[path] += inner
        if self._open:
            self._open[-1][2] += dt

    def snapshot(self) -> dict:
        """{(name, parent name or None): (count, total s, self s)}, summed
        over the paths that end so."""
        out = {}
        for path, n in self._count.items():
            key = (path[-1], path[-2] if len(path) > 1 else None)
            c, t, s = out.get(key, (0, 0.0, 0.0))
            out[key] = (c + n, t + self._total[path],
                        s + self._total[path] - self._inner[path])
        return out

    def report(self) -> str:
        """The span tree, children by total time: count, total and self
        seconds, ms per span."""
        lines = [f"{'Span':<40}{'Count':>9}{'Total (s)':>12}{'Self (s)':>12}"
                 f"{'Avg (ms)':>11}"]

        def walk(parent: tuple) -> None:
            kids = [p for p in self._count
                    if len(p) == len(parent) + 1 and p[:-1] == parent]
            for p in sorted(kids, key=lambda p: -self._total[p]):
                n, tot = self._count[p], self._total[p]
                label = "  " * (len(p) - 1) + p[-1]
                lines.append(f"{label:<40}{n:>9}{tot:>12.4f}"
                             f"{tot - self._inner[p]:>12.4f}"
                             f"{1e3 * tot / n:>11.3f}")
                walk(p)

        walk(())
        return "\n".join(lines)


class _Span:
    __slots__ = ("name", "_log", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._log = _log
        self._log.enter(self.name)
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        self._log.exit()
        return False


def enable(log: Optional[EventLog] = None) -> EventLog:
    """Record spans from now on, into `log` or a new log; returns it."""
    global _on, _log
    _log = log if log is not None else EventLog()
    _on = True
    return _log


def disable() -> None:
    """Stop recording (the log keeps what it holds)."""
    global _on
    _on = False


def active() -> Optional[EventLog]:
    """The log spans record into, None while spans are off."""
    return _log if _on else None


def span(name: str):
    """Context manager: span `name` where spans are on."""
    return _Span(name) if _on else _OFF


def spanned(name: str):
    """Decorator for a function or method: each call runs inside span
    `name` where spans are on at the call."""
    def decorate(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return run
    return decorate


def wrap(name: str):
    """Decorator for a closure built once per solve: wrapped in span `name`
    if spans are on when it is built, else returned as it is."""
    def decorate(fn):
        if not _on:
            return fn

        def run(*args, **kwargs):
            with _Span(name):
                return fn(*args, **kwargs)
        return run
    return decorate


def fetch(t: torch.Tensor) -> torch.Tensor:
    """`t.cpu()`: the host waits on the device.  Counted in `syncs`; span
    `sync` where spans are on."""
    global syncs
    syncs += 1
    if not _on:
        return t.cpu()
    with _Span("sync"):
        return t.cpu()


def wait(event) -> None:
    """`event.synchronize()`: the host waits on the device's work up to
    `event` (a copy to pinned host memory), not on the whole stream.
    Counted in `syncs`; span `sync` where spans are on."""
    global syncs
    syncs += 1
    if not _on:
        event.synchronize()
        return
    with _Span("sync"):
        event.synchronize()


def counters() -> dict:
    """The always-on counters now, by name (`COUNTERS`)."""
    return {name: globals()[name] for name in COUNTERS}
