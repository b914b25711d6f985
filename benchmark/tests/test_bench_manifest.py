"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to a file of its own."""
import importlib
import json
import re

import pytest

from benchmark.harness import main as harness

ROOT = harness.ROOT
HERE = harness.HERE
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for x in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for m in MANIFEST["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\t" not in m["layer"]


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_resolves(cell):
    spec = harness.resolve(MANIFEST, cell)
    assert spec["cell"]["chips"] == 1
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(importlib.import_module(
            f"benchmark.metrics.{m['name']}").read)
    config = spec["config"]
    importlib.import_module(f"benchmark.drivers.{config['driver']}").Driver
    for q in config.get("queries", []):
        importlib.import_module(f"benchmark.queries.{q}").build
        importlib.import_module(f"benchmark.reference.{q}").plain
    assert set(config["limits"]) and all(v == 0 for v in
                                         config["limits"].values())


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("benchmark/")
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["name"] == c["name"]
        assert len(c["reduced"]) <= 16


def test_per_layer_metrics():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
