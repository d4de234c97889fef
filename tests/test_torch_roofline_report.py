"""``benchmarks_torch.roofline_report`` against ``benchmarks.roofline_report``
over the same dry-run entries.

The entries are the port's own: ``repro_torch.launch.dryrun`` traces the
FULL ``dlrm-uih`` and ``dcn-v2`` cells on the pod mesh (two CPU
subprocesses in turn, one results file each), and a third file holds a failed
entry and copies of the pod entries on ``multipod`` with their collective
time doubled. The reference's report reads the same entries under its key
names (``t_compile_s`` for ``t_trace_s``, ``memory.temp_size_in_bytes`` for
``memory.peak_bytes_per_chip``) from a file its ``RESULTS`` is pointed at.
The roofline rows and the hillclimb picks must be equal; the dry-run table
has one row per ``ok`` entry with the port's trace and peak columns.
"""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:  # make `benchmarks*.*` importable
    sys.path.insert(0, str(REPO_ROOT))

from benchmarks import roofline_report as ref  # noqa: E402
from benchmarks_torch import roofline_report as port  # noqa: E402

ARCHS = ("dlrm-uih", "dcn-v2")
MESHES = ("pod", "multipod")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(port's files, reference's file, merged entries)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    files = [tmp / f"dryrun_pod_{a}_torch.json" for a in ARCHS]
    for a, f in zip(ARCHS, files):    # one at a time: one core's load
        out = subprocess.run(
            [sys.executable, "-W", "ignore", "-m",
             "repro_torch.launch.dryrun", "--arch", a, "--mesh", "pod",
             "--out", str(f)],
            cwd=REPO_ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    entries = port.read_results(files)
    extra = {"dlrm-uih|serve_p99|pod-failed": {
        "arch": "dlrm-uih", "shape": "serve_p99", "mesh": "pod",
        "ok": False, "error": "RuntimeError: a failed cell"}}
    for key, v in entries.items():
        if v["mesh"] == "pod":
            m = copy.deepcopy(v)
            m["mesh"] = m["roofline"]["mesh"] = "multipod"
            m["roofline"]["t_collective_s"] *= 2.0
            extra[key.replace("|pod", "|multipod")] = m
    files.append(tmp / "extra.json")
    files[-1].write_text(json.dumps(extra))
    entries = port.read_results(files)
    as_ref = {}
    for key, v in entries.items():
        v = copy.deepcopy(v)
        if v.get("ok"):
            v["t_compile_s"] = v["t_trace_s"]
            v["memory"]["temp_size_in_bytes"] = \
                v["memory"]["peak_bytes_per_chip"]
        as_ref[key] = v
    ref_file = tmp / "dryrun_results.json"
    ref_file.write_text(json.dumps(as_ref))
    return files, ref_file, entries


def _ok(entries, mesh):
    return sorted(k for k, v in entries.items()
                  if v.get("ok") and v["mesh"] == mesh)


@pytest.mark.parametrize("mesh", MESHES)
def test_roofline_rows_and_picks_equal_the_reference(results, mesh,
                                                     monkeypatch):
    files, ref_file, entries = results
    monkeypatch.setattr(ref, "RESULTS", ref_file)
    got = port.roofline_table(mesh, files)
    assert got == ref.roofline_table(mesh)
    assert len(got.splitlines()) == 2 + len(_ok(entries, mesh))
    picks = port.pick_hillclimb(mesh, files)
    assert picks == ref.pick_hillclimb(mesh)
    assert picks["paper_representative"] == "dlrm-uih|train_batch"
    assert {f"{p}|{mesh}" for p in picks.values()} <= set(_ok(entries, mesh))


@pytest.mark.parametrize("mesh", MESHES)
def test_dryrun_table_one_row_per_ok_entry(results, mesh, monkeypatch):
    files, ref_file, entries = results
    monkeypatch.setattr(ref, "RESULTS", ref_file)
    header, rule, *rows = port.dryrun_table(mesh, files).splitlines()
    assert header.split(" | ")[3:6] == ["trace", "HBM/chip (args)",
                                        "peak/chip"]
    keys = _ok(entries, mesh)
    assert len(rows) == len(keys) > 0
    for row, key in zip(rows, keys):
        v = entries[key]
        cols = [c.strip() for c in row.strip("|").split("|")]
        assert cols[:3] == [v["arch"], v["shape"], v["kind"]]
        assert cols[3] == f"{v['t_trace_s']}s"
        assert cols[5] == port.fmt_b(v["memory"]["peak_bytes_per_chip"])
    # the reference's table, given the port's trace time and peak under its
    # column keys, has the same rows
    assert rows == ref.dryrun_table(mesh).splitlines()[2:]


def test_results_merge_in_order(results, tmp_path):
    files, _, entries = results
    key = _ok(entries, "pod")[0]
    later = tmp_path / "later.json"
    later.write_text(json.dumps({key: {**entries[key], "t_trace_s": 123.0}}))
    assert port.read_results(files + [later])[key]["t_trace_s"] == 123.0
    assert port.read_results([later] + files)[key]["t_trace_s"] == \
        entries[key]["t_trace_s"]


def test_main_runs_on_the_cpu(results, capsys):
    files, _, _ = results
    port.main(["--mesh", "pod", "--results", *map(str, files)])
    out = capsys.readouterr().out
    assert out.startswith("## Dry-run (pod)\n")
    assert "\n## Roofline (pod)\n" in out
    picks = json.loads(out.split("## Hillclimb candidates\n", 1)[1])
    assert picks == port.pick_hillclimb("pod", files)
    assert out == port.report("pod", files) + "\n"
