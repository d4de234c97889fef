"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of its own."""
from __future__ import annotations

import json
import re

import pytest

from bench.harness.manifest import BENCH, ROOT, find_cell, load_manifest, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert M["paths"] == ["bench"] and M["command"][1] == "bench/run.py"
    assert 2 + 14 * 24 <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_are_plain(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text
            assert "\t" not in text


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    if metric in M["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}


def test_names_unique():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    e2e = {m["name"]: m for m in M["end_to_end"]}
    target = e2e[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert cell in target.get("workloads", CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = find_cell(name)
    assert cell.chips in (1, 4)
    assert (BENCH / "workloads" / f"{name}.json").exists()
    assert set(cell.limits) == {"batch_mismatch", "loss_gap", "grad_gap",
                                "change_gap"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert cell.traffic["mode"] in ("feed", "ring")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reader(m["name"]).read)


@pytest.mark.parametrize("entry", M["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    path = ROOT / entry["file"]
    assert path.parts[len(ROOT.parts)] == "bench"
    cfg = json.loads(path.read_text())
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["source"] == entry["source"]
    assert (BENCH / "reference" / f"{cfg['family']}.py").exists()
    assert (BENCH / "models" / f"{cfg['family']}.py").exists()
    used = [w for w in M["workloads"] if w["config"] == entry["name"]]
    assert used


def test_four_chip_cells_within_share():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
