"""The harness finds configurations, traffic mixes and metrics by name,
and BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import shutil

import pytest

from h100_bench.harness import bench, named

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves(spec):
    for cell in spec["workloads"]:
        _, config, traffic, e2e, layer = bench.resolve(cell["name"], spec)
        assert config["name"] == cell["config"]
        entry = named.module("entries", traffic["entry"])
        assert all(callable(getattr(entry, f)) for f in ("build", "reference", "answers", "limit"))
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer, f"{cell['name']} reports no per-layer metric"
        for m in e2e + layer:
            assert callable(bench.metric_reader(m["name"]))


def test_contract_shape(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "h100_bench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    assert len(set(names)) == len(names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100_bench/") and NAME.match(c["name"])
        assert json.loads((bench.CHECKOUT / c["file"]).read_text())["name"] == c["name"]
    pairs = {(w["config"], w["traffic"]) for w in spec["workloads"]}
    assert len(pairs) == len(spec["workloads"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in names
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


def test_new_files_are_found_without_an_edit(spec, tmp_path):
    """A cell, its configuration, its mix and a metric added as new files
    and entries are picked up; no file that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(bench.BENCH, root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "h100_bench").rglob("*") if p.is_file()}
    cfg = json.loads((root / "h100_bench/configs/atlite-gb-2011-01.json").read_text())
    cfg["name"] = "gb-new"
    (root / "h100_bench/configs/gb-new.json").write_text(json.dumps(cfg))
    (root / "h100_bench/traffic/new-mix.json").write_text(
        json.dumps({"entry": "convert", "call_kwargs": {"time_chunk": 0}, "sample": 1,
                    "trace_seconds": 1}))
    (root / "h100_bench/metrics/new_metric.py").write_text("def read(run):\n    return 42.0\n")
    spec = json.loads(json.dumps(spec))
    spec["workloads"].append({"name": "new-cell", "config": "gb-new", "traffic": "new-mix",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                              "source": "program_counter", "layer": "a test",
                              "moves": "call_ms", "workloads": ["new-cell"]})
    cell, config, traffic, e2e, layer = bench.resolve("new-cell", spec, bench=root / "h100_bench")
    assert config["name"] == "gb-new" and traffic["sample"] == 1
    assert [m["name"] for m in layer] == ["new_metric"]
    assert {m["name"] for m in e2e} == {m["name"] for m in spec["end_to_end"]
                                        if "workloads" not in m
                                        or "new-cell" in m["workloads"]}
    assert bench.read_metrics(layer, None, root / "h100_bench") == {
        "new_metric": {"value": 42.0, "unit": "ms"}}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_unknown_cell(spec):
    with pytest.raises(KeyError):
        bench.resolve("no-such-cell", spec)


# a new kind of entry: its calls, its reference, its answers and its limit
NEW_ENTRY = """
import numpy as np
import torch


def build(session):
    n = session.config["n"]
    session.add("ramp", lambda: np.arange(n, dtype=np.float32).reshape(n, 1) + session.seed % 7,
                {"T": n, "B": 1})


def reference(session, label, dtype, device):
    n = session.config["n"]
    return [torch.arange(n, dtype=dtype, device=device).reshape(n, 1) + session.seed % 7]


def answers(answer):
    return [answer]


def limit(session, label):
    return 0.0
"""


def test_new_entry_runs_without_an_edit(spec, tmp_path):
    """A cell whose mix names an entry that only a new file defines runs
    through the whole harness and is judged by that file's reference."""
    root = tmp_path / "h100_bench"
    shutil.copytree(bench.BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "entries/ramp.py").write_text(NEW_ENTRY)
    (root / "configs/ramp-config.json").write_text(json.dumps({"name": "ramp-config", "n": 5}))
    (root / "traffic/ramp-mix.json").write_text(
        json.dumps({"entry": "ramp", "sample": 2, "trace_seconds": 1}))
    spec = json.loads(json.dumps(spec))
    spec["workloads"].append({"name": "ramp-cell", "config": "ramp-config",
                              "traffic": "ramp-mix", "chips": 1, "why": "a test"})
    resolved = bench.resolve("ramp-cell", spec, bench=root)
    result, checks = bench.run_cell(*resolved, 2**31 + 5, 0.05, 0, "cpu", bench=root)
    assert result["correct"] and result["attempted"] >= 1, checks
    assert ("rel_l2.ramp", 0.0, 0.0) in checks
    assert all(p.read_bytes() == b for p, b in before.items())
