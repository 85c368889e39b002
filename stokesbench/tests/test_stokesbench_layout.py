"""Every configuration, traffic mix, limit file and metric that
BENCHMARK.json names is a file of its own that the harness finds by name,
and the file keeps to the benchmark's contract."""

import importlib
import json
import re
from pathlib import Path

import pytest

from stokesbench import harness

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(cell):
    found = harness.Cell.find(cell["name"], BENCH)
    assert found.config["name"] == cell["config"]
    assert found.traffic["name"] == cell["traffic"]
    # every limit names a number the reference judges in this configuration
    judged = {"geometry", "state", "velocity", "traction"} | ({"omega"} if found.config["problem"].get(
        "solve_with_torque") else set())
    assert set(found.limits) == judged
    assert any(m["name"] == "setup_s" for m in found.end_to_end)
    assert len(found.end_to_end) >= 2 and found.per_layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_found_by_name(metric):
    assert callable(importlib.import_module(f"stokesbench.metrics.{metric['name']}").read)
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for w in metric.get("workloads", ()):
        assert w in {c["name"] for c in BENCH["workloads"]}


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("stokesbench/")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
