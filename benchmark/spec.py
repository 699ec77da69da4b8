"""What the benchmark measures, found by name.

`BENCHMARK.json` at the root of the checkout lists the configurations,
the cells and the metrics.  Each has a file of its own:
`benchmark/configs/<config>.json` (the path `BENCHMARK.json` gives),
`benchmark/workloads/<cell>.json` (the traffic of one cell) and
`benchmark/metrics/<metric>.py` (one reader).  Adding one is adding its
file and its entry; no code here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """`BENCHMARK.json` and the files it names, under `root`."""

    def __init__(self, bench: dict, root: Path = ROOT,
                 workload_dir: Path = HERE / "workloads",
                 metric_dir: Path = HERE / "metrics"):
        self.bench = bench
        self.root = Path(root)
        self.workload_dir = Path(workload_dir)
        self.metric_dir = Path(metric_dir)

    @classmethod
    def load(cls, root: Path = ROOT) -> "Spec":
        return cls(load_json(Path(root) / "BENCHMARK.json"), root)

    def _entry(self, key: str, name: str) -> dict:
        for entry in self.bench[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"{key}: no entry named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        """The cell's entry, its traffic file merged in."""
        entry = self._entry("workloads", name)
        traffic = load_json(self.workload_dir / f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if traffic.get(key) != entry[key]:
                raise ValueError(f"{name}: {key} {traffic.get(key)!r} in its "
                                 f"file, {entry[key]!r} in BENCHMARK.json")
        return {**traffic, **entry}

    def config(self, name: str) -> dict:
        return load_json(self.root / self._entry("configs", name)["file"])

    def metrics(self, cell: str, trace: bool) -> list:
        """(entry, reader module) of each metric the cell reports: the
        per-layer ones in a traced run, else the end-to-end ones; a metric
        with `workloads` only in the cells it lists."""
        key = "per_layer" if trace else "end_to_end"
        return [(m, load_reader(self.metric_dir, m["name"]))
                for m in self.bench[key]
                if cell in m.get("workloads", (cell,))]


def load_reader(metric_dir: Path, name: str):
    """benchmark/metrics/<name>.py as a module; it defines UNIT and
    read(readings) -> float or None."""
    path = Path(metric_dir) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
