"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``), traffic (``traffic/<mix>.json``) and each
metric's reader (``metrics/<metric>.py``), found by name."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Manifest:
    """``data``: BENCHMARK.json's content (default: the file at the root);
    ``bench_dir``: where ``configs/``, ``traffic/`` and ``metrics/``
    lie."""

    def __init__(self, data: dict = None, bench_dir: str = BENCH_DIR):
        if data is None:
            with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
                data = json.load(fh)
        self.data = data
        self.bench_dir = bench_dir

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.bench_dir, kind, name + ".json")) as fh:
            return json.load(fh)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def metrics(self, cell: str, traced: bool):
        """The metric entries a run of ``cell`` reports: its end-to-end
        metrics, or with ``traced`` its per-layer ones."""
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read(run)``."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
