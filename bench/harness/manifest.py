"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell ``<name>`` is ``workloads/<name>.json`` (its limits), its
configuration is the manifest's ``file`` (the sizes and the family, whose
program adapter is ``models/<family>.py`` and whose plain reference is
``reference/<family>.py``), its traffic mix ``traffic/<traffic>.json``, and
each metric ``metrics/<metric>.py``. Adding a cell, a mix or a metric adds
files and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file, with its manifest name
    traffic: dict          # the traffic mix's file, with its name
    limits: dict           # number compared -> limit
    end_to_end: List[dict]
    per_layer: List[dict]


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def find_cell(name: str, root: Path = ROOT) -> Cell:
    m = load_manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in m["configs"]}[w["config"]]
    config = dict(_json(root / cfg_entry["file"]), name=w["config"])
    traffic = dict(_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                   name=w["traffic"])
    cell_file = _json(BENCH / "workloads" / f"{name}.json")

    def mine(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    e2e = [x for x in m["end_to_end"] if mine(x)]
    reported = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"]
                 if mine(x) and x["moves"] in reported]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=cell_file["limits"], end_to_end=e2e,
                per_layer=per_layer)


def family(config: dict):
    """The configuration's program adapter (``bench.models.<family>``)."""
    return importlib.import_module(f"bench.models.{config['family']}")


def reader(metric: str):
    """The reader of one metric (``bench.metrics.<name>``, dots as ``_``)."""
    return importlib.import_module(
        f"bench.metrics.{metric.replace('.', '_')}")
