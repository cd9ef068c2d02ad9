"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own under the benchmark's folder:

- ``configs/<config>.json``: the configuration's sizes and layer list;
- ``workloads/<traffic>.json``: the traffic mix of a cell;
- ``methods/<method>.py`` and ``reference/methods/<method>.py``: the
  method's rule set-up on the program's side and its term in the plain
  reference;
- ``metrics/<metric>.py``: the reader of a per-layer metric, a function
  ``read(record)`` that returns the metric's value, or None where the run
  holds nothing for it to read.

So a later change adds a cell, a configuration or a metric by adding files
and entries, and edits none of these."""

from __future__ import annotations

import importlib.util
import json
import os

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)


class Spec:
    """The benchmark's entries and files. ``root`` is the folder that
    holds ``configs/``, ``workloads/`` and ``metrics/`` (the package's own
    by default); ``bench`` the path of ``BENCHMARK.json``."""

    def __init__(self, bench: str | None = None, root: str | None = None):
        self.root = root or PKG_DIR
        with open(bench or os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def _json(self, folder: str, name: str) -> dict:
        with open(os.path.join(self.root, folder, f"{name}.json")) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")

    def workload(self, name: str) -> dict:
        """The cell's traffic file, checked against its entry."""
        cell = self.cell(name)
        wl = self._json("workloads", cell["traffic"])
        if wl["config"] != cell["config"]:
            raise ValueError(f"{name}: traffic {cell['traffic']} is for "
                             f"{wl['config']}, the entry says "
                             f"{cell['config']}")
        return wl

    def config(self, name: str) -> dict:
        cfg = self._json("configs", name)
        if cfg["name"] != name:
            raise ValueError(f"configs/{name}.json names itself "
                             f"{cfg['name']!r}")
        return cfg

    def _applies(self, metric: dict, cell: str) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        moves = self.metric(metric["moves"])
        return "workloads" not in moves or cell in moves["workloads"]

    def metric(self, name: str) -> dict:
        for m in self.bench["end_to_end"] + self.bench["per_layer"]:
            if m["name"] == name:
                return m
        raise KeyError(f"BENCHMARK.json has no metric {name!r}")

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.bench["per_layer"] if self._applies(m, cell)]

    def reader(self, name: str):
        """The module ``metrics/<name>.py`` (a name may hold dots, so the
        file is loaded by its path)."""
        path = os.path.join(self.root, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"clbench_metric_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
