"""BENCHMARK.json against the files it names and against itself."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def contract() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_cells_name_their_files(contract):
    configs = {c["name"]: c for c in contract["configs"]}
    for w in contract["workloads"]:
        cell = harness.Cell(BENCH, w["name"])
        assert cell.spec["config"] == w["config"] and cell.spec["traffic"] == w["traffic"]
        assert (BENCH / "traffic" / f"{cell.spec['driver']}.py").exists()
        assert cell.config["name"] == w["config"]
        assert (ROOT / configs[w["config"]]["file"]).exists()
        assert cell.config["source"] == configs[w["config"]]["source"]
    assert {w["config"] for w in contract["workloads"]} == set(configs)


def _cells_reporting(contract, metric: dict) -> set:
    return set(metric.get("workloads", [w["name"] for w in contract["workloads"]]))


def test_every_per_layer_metric_moves_a_metric_its_cells_report(contract):
    e2e = {m["name"]: m for m in contract["end_to_end"]}
    for m in contract["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert _cells_reporting(contract, m) <= _cells_reporting(contract, e2e[m["moves"]])
        assert harness.Cell(BENCH, next(iter(_cells_reporting(contract, m)))).reader(m["name"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(contract):
    for w in contract["workloads"]:
        e2e = [m["name"] for m in contract["end_to_end"] if w["name"] in _cells_reporting(
            contract, m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in contract["per_layer"] if w["name"] in _cells_reporting(contract, m)]
        kinds = {m["name"].split(".")[0] for m in layers}
        assert {"mfu", "kernel_roofline", "device_idle"} <= kinds


def test_names_units_and_bounds(contract):
    names = [m["name"] for m in contract["end_to_end"] + contract["per_layer"]]
    names += [w["name"] for w in contract["workloads"]] + [c["name"] for c in contract["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in contract["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in contract["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert len(layers) >= 5


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import subprocess
    import sys

    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "file-1.7b",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, cwd=ROOT,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0 and r.stdout.strip() == ""
