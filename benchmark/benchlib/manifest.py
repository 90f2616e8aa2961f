"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``), traffic (``traffic/<mix>.json``), the
adapter of the program that the configuration runs
(``systems/<adapter>.py``) and each metric's reader
(``metrics/<metric>.py``), found by name."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Manifest:
    """``data``: BENCHMARK.json's content (default: the file at the root);
    ``bench_dir``: where ``configs/``, ``traffic/``, ``systems/`` and
    ``metrics/`` lie."""

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
        return self._module("metrics", metric).read

    def system(self, config: dict):
        """The adapter that ``config`` names under ``"adapter"``:
        ``systems/<adapter>.py`` as a module, which builds, drives and
        checks the configuration's program (``KEYS``, ``MESH_ENTRIES``,
        ``check``, ``make``, ``entries``, ``reference``: see
        ``systems/fvc.py``). Raises ValueError, naming the file, where
        the configuration names none or the file is not there."""
        name = config.get("adapter")
        where = os.path.join(self.bench_dir, "systems")
        if not name:
            raise ValueError(f"configuration {config.get('name')!r} names "
                             "no adapter: give it \"adapter\" and the file "
                             f"{where}/<adapter>.py")
        if not os.path.isfile(os.path.join(where, name + ".py")):
            raise ValueError(f"configuration {config.get('name')!r}: its "
                             f"adapter's file {where}/{name}.py is not "
                             "there")
        return self._module("systems", name)

    def _module(self, kind: str, name: str):
        """``<kind>/<name>.py``, loaded anew."""
        path = os.path.join(self.bench_dir, kind, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
