"""The device trace of a traced run, and its reduction.

`Capture` profiles whole segments with `torch.profiler` (CPU and CUDA
activities), inside one annotation per segment, and writes the Chrome
trace under TMPDIR.  `reduce_trace` reads it back: the device operations
(kernels, copies, fills) inside the annotated windows, their busy time as
the union of their intervals, the time by kernel name, and the idle gaps
labelled by what the host was doing in them.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

ANNOTATION = "benchmark.segment"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}


class Capture:
    """Profiles what runs inside it, in one annotation; `.path` holds the
    trace."""

    def __init__(self):
        self.path = None
        self._prof = None
        self._range = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(ANNOTATION)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        fd, self.path = tempfile.mkstemp(prefix="benchmark_trace_",
                                         suffix=".json")
        os.close(fd)
        self._prof.export_chrome_trace(self.path)
        return False


def _union(intervals: list) -> tuple:
    """(covered length, gaps) of [(start, end)] sorted by start."""
    covered, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    return covered, gaps


def _label(host: list, starts: list, t: float) -> str:
    """The innermost host operation running at time t, else 'python'."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(i - 64, -1), -1):
        s, e, name = host[j]
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "python"


def reduce_trace(path: str, top: int = 10) -> dict:
    """Busy and window seconds, kernels, time by kernel name, idle gaps by
    host operation, over the annotated windows of the trace at `path`."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    windows = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("name") == ANNOTATION
                     and e.get("ph") == "X"
                     and e.get("cat") == "user_annotation")
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "").lower()
        s = float(e["ts"])
        item = (s, s + float(e["dur"]), e.get("name", ""))
        if cat in DEVICE_CATS:
            dev.append(item + (cat,))
        elif cat in HOST_CATS:
            host.append(item)

    def inside(s, e):
        return any(ws <= s and e <= we for ws, we in windows)

    dev = sorted(d for d in dev if inside(d[0], d[1]))
    host.sort()
    starts = [h[0] for h in host]
    by_name = defaultdict(float)
    kernels = []
    for s, e, name, cat in dev:
        by_name[name] += e - s
        if cat == "kernel":
            kernels.append((name, e - s))
    busy = 0.0
    idle = defaultdict(float)
    for ws, we in windows:
        ops = [(max(s, ws), min(e, we)) for s, e, _, _ in dev
               if s < we and e > ws]
        covered, gaps = _union(ops)
        busy += covered
        edges = ([(ws, ops[0][0])] if ops else []) + gaps + (
            [(max(e for _, e in ops), we)] if ops else [(ws, we)])
        for gs, ge in edges:
            if ge > gs:
                idle[_label(host, starts, (gs + ge) / 2)] += ge - gs
    window_us = sum(we - ws for ws, we in windows)
    rank = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": window_us * 1e-6,
        "busy_s": busy * 1e-6,
        "kernels": kernels,
        "device_ops": [[n[:200], t * 1e-6] for n, t in rank],
        "idle_gaps": [[n[:200], t * 1e-6] for n, t in gaps],
    }
