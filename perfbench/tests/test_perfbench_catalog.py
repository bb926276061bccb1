"""The harness finds every part of a cell by name, BENCHMARK.json the one
record of what a cell and a metric are, and a new cell, configuration,
traffic mix and metric are files and entries alone: no file that is
already there changes.  BENCHMARK.json keeps to the contract's names,
units and references."""

import json
import re
import shutil
from pathlib import Path

import pytest

from harness import cli
from harness.catalog import BENCH_DIR, ROOT, Catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    metrics = b["end_to_end"] + b["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in b["workloads"]:
        mine = lambda ms: [m for m in ms if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine(b["end_to_end"])}
        assert len(mine(b["end_to_end"])) >= 2 and mine(b["per_layer"])
        for m in mine(b["per_layer"]):  # each reports the end-to-end metric it moves
            assert m["moves"] in {e["name"] for e in mine(b["end_to_end"])}
    assert len(json.dumps(b)) < 64 * 1024


def test_every_part_is_found_by_name():
    cat = Catalog()
    b = cat.benchmark
    for w in b["workloads"]:
        cell = cat.cell(w["name"])
        assert cat.config(cell["config"])["name"] == cell["config"]
        assert cat.traffic(cell["traffic"])["kind"]
        assert cat.entry(cell["entry"]).__name__ == "Entry"
    for group in ("end_to_end", "per_layer"):
        for m in b[group]:
            assert callable(cat.reader(m["name"]).read)
    on_disk = {p.stem for p in (BENCH_DIR / "metrics").glob("*.py")}
    assert on_disk == {m["name"] for g in ("end_to_end", "per_layer") for m in b[g]}
    assert {p.stem for p in (BENCH_DIR / "cells").glob("*.json")} == {w["name"] for w in b["workloads"]}


def test_a_new_cell_config_traffic_and_metric_are_files_alone(tmp_path):
    root = tmp_path / "checkout"
    bench_dir = root / "perfbench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}

    (bench_dir / "configs" / "dummy-config.json").write_text(json.dumps(
        {"name": "dummy-config", "n": 4096, "reduced": []}))
    (bench_dir / "traffic" / "dummy-traffic.json").write_text(json.dumps(
        {"kind": "msm_scalars", "vectors": 2}))
    (bench_dir / "cells" / "dummy-cell.json").write_text(json.dumps({"entry": "msm_commit"}))
    (bench_dir / "metrics" / "dummy_calls.py").write_text(
        'def read(run):\n    return float(len(run.records))\n')
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "dummy-config", "source": "https://example.org/dummy",
                         "file": "perfbench/configs/dummy-config.json", "reduced": [],
                         "why": "a dummy"})
    b["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                           "traffic": "dummy-traffic", "chips": 1, "why": "a dummy"})
    b["end_to_end"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                            "bound": 0.25, "source": "host_clock", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cat = Catalog(root, bench_dir)
    cell = cat.cell("dummy-cell")
    assert cell["entry"] == "msm_commit" and cell["why"] == "a dummy"
    assert cat.config(cell["config"])["n"] == 4096
    assert cat.traffic(cell["traffic"])["vectors"] == 2
    assert [(n, u) for n, u, _ in cat.metrics("dummy-cell", trace=False)] == [
        ("setup_s", "s"), ("dummy_calls", "calls")]
    assert [n for n, _, _ in cat.metrics("dummy-cell", trace=True)] == ["setup.inputs_s",
                                                                       "setup.warmup_s"]
    assert [n for n, _, _ in cat.metrics("msm-k21", trace=False)] == ["msm_points_per_s",
                                                                      "setup_s"]
    reader = dict((n, r) for n, _, r in cat.metrics("dummy-cell", trace=False))["dummy_calls"]
    assert reader.read(cli.Run("dummy-cell", {}, {}, 1, 1.0, False, records=[1, 2])) == 2.0
    changed = [p for p, data in before.items()
               if p != Path("BENCHMARK.json") and (root / p).read_bytes() != data]
    assert changed == []
    with pytest.raises(KeyError):
        cat.cell("no-such-cell")


def test_a_missing_span_target_stops_the_traced_run():
    from harness import RunError, trace

    with trace.spans_around(("harness.stats:rate",)) as names:
        assert names == ["bench::rate"]
    with pytest.raises(RunError, match="harness.stats:no_such_function"):
        with trace.spans_around(("harness.stats:rate", "harness.stats:no_such_function")):
            pass
    from harness import stats
    assert stats.rate.__name__ == "rate"  # nothing left wrapped
