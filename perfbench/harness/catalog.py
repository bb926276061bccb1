"""Find a cell's parts by name: its entry in BENCHMARK.json, the
configuration and traffic files it names, its entry module and the
readers of its metrics."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent  # perfbench/
ROOT = BENCH_DIR.parent  # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Catalog:
    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.benchmark = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        """The cell's BENCHMARK.json entry and its `entry` (cells/<name>.json)."""
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return dict(w, entry=load_json(self.dir / "cells" / f"{name}.json")["entry"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def entry(self, name: str):
        """The Entry class of harness/entries/<name>.py."""
        return importlib.import_module(f"harness.entries.{name}").Entry

    def metrics(self, cell: str, trace: bool):
        """The (name, unit, reader) of every metric the cell reports: the
        end-to-end ones without tracing, the per-layer ones with it; a
        metric with a `workloads` key only in the cells it lists."""
        group = self.benchmark["per_layer" if trace else "end_to_end"]
        return [(m["name"], m["unit"], self.reader(m["name"])) for m in group
                if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        """The module metrics/<name>.py: its `read(run)`."""
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
