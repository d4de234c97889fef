"""Whole runs: without a card the command fails and prints no result; on
the CPU at test sizes a sound run is correct, and the control and every
planted fault come out not correct."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench.harness.manifest as manifest
from bench import run as bench_run
from bench.harness import driver
from bench.reference.precision import CONTROL
from bench.tests.cells import smoke_cell

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "dcn_v2.ring.b1024", "--seed", "3000000007",
        "--seconds", "1", "--trace", "0"]


def _command(cwd: Path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(cwd)}
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_fails_without_a_card():
    out = _command(ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA" in out.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def _run(monkeypatch, name, faults=None, limits=None, seconds="0.5"):
    cell = smoke_cell(name, limits)
    monkeypatch.setattr(manifest, "find_cell", lambda _: cell)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    argv = ["--workload", name, "--seed", "2147483659", "--seconds", seconds,
            "--trace", "0"]
    return bench_run.main(argv, device="cpu", faults=faults)


@pytest.mark.parametrize("name", ["dlrm_uih.feed", "dcn_v2.feed",
                                  "dcn_v2.ring"])
def test_sound_run_is_correct(monkeypatch, capsys, name):
    line = _run(monkeypatch, name, seconds="2")
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"train_examples_per_s", "setup_s"} <= set(line["metrics"])
    assert list(line)[-1] == "checks"
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == line
    tail = printed.err.strip().splitlines()[-4:]
    assert [t.split()[0] for t in tail] == list(line["checks"])


def _half_batch(loss_fn):
    def broken(params, batch):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return loss_fn(params, half)
    return broken


def _alter_token(batch):
    lane = batch["uih_item_id"].clone()
    row = int(batch["uih_mask"].sum(1).argmax())
    lane[row, -1] += 1
    return dict(batch, uih_item_id=lane)


FAULTS = {
    "frozen": {"frozen": True},
    "half_batch": {"loss": _half_batch},
    "token": {"batch": _alter_token},
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["dlrm_uih.feed", "dcn_v2.feed",
                                  "dcn_v2.ring"])
def test_planted_fault_is_not_correct(monkeypatch, name, fault):
    line = _run(monkeypatch, name, faults=FAULTS[fault])
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert failed


@pytest.mark.parametrize("name", ["dlrm_uih.feed", "dcn_v2.ring"])
def test_control_is_not_correct(monkeypatch, name):
    """The reference in float8 operands put in the program's place."""
    cell = smoke_cell(name)
    from bench.models import dcn_v2, dlrm_uih

    fam = {"dlrm_uih": dlrm_uih, "dcn_v2": dcn_v2}[cell.config["family"]]
    ref = fam.reference
    monkeypatch.setattr(
        fam, "program_loss",
        lambda cfg: lambda p, b: ref.loss(p, ref.prep(b, cfg), cfg, CONTROL))
    line = _run(monkeypatch, name)
    assert line["correct"] is False


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels have no CPU "
                    "path here")
    out = subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_driver_has_three_warm_steps():
    assert driver.WARM_STEPS == 3
