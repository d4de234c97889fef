"""The port's telemetry report against the reference's: one run directory,
written by the port's ``Telemetry`` over a streaming feed with a backfill
flip, a worker crash and a stream disconnect, renders to the same text with
both ``render_report``s and with ``python -m repro_torch.obs.report``."""
import os
import subprocess
import sys
from pathlib import Path

from repro.obs.report import render_report as ref_render
from repro_torch.core import events as ev
from repro_torch.core.projection import TenantProjection
from repro_torch.core.simulation import ProductionSim, SimConfig
from repro_torch.data import DatasetSpec, StreamSource, open_feed
from repro_torch.dpp.featurize import FeatureSpec
from repro_torch.obs import Telemetry
from repro_torch.obs.report import render_report
from repro_torch.testing import FaultPlan, FaultSpec, wrap_sim

REPO = Path(__file__).resolve().parent.parent


def _stream_run_dir(root):
    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=6, n_items=1_500, days=4,
                               events_per_user_day_mean=25.0, seed=5),
        stripe_len=16, requests_per_user_day=3, seed=5, pin_generations=True))
    sim.run_days(1)
    sim.run_day(1)                 # after the sealed hours: the live leg
    sim.stream.close()
    plan = FaultPlan([FaultSpec("worker_crash", 1),
                      FaultSpec("stream_disconnect", 3)])
    tel = Telemetry(sample_every=1)
    traits = ("timestamp", "item_id", "action_type")
    spec = DatasetSpec(
        tenant=TenantProjection("t", 16, ("core",),
                                traits_per_group={"core": traits}),
        source=StreamSource(backfill_end_hour=23),
        features=FeatureSpec(seq_len=16, uih_traits=traits[1:]),
        batch_size=8, base_batch_size=4, n_workers=2, prefetch_depth=2,
        window_cache_size=0, generations="pinned", telemetry=tel)
    feed = open_feed(spec, wrap_sim(sim, plan), device="cpu")
    for _ in feed:
        feed.record_train_step(0.001)
    feed.join()
    feed.close()
    assert plan.n_fired == 2
    assert feed.session.backfill_stats.flipped
    return tel.write_run_dir(root / "run")


def test_port_report_renders_the_reference_text(tmp_path):
    run_dir = _stream_run_dir(tmp_path)
    got = render_report(run_dir, top_k=3)
    assert got == ref_render(run_dir, top_k=3)
    for part in ("per-stage breakdown", "starvation attribution",
                 "worker_restart", "stream_reconnect", "backfill_flip"):
        assert part in got, part
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(run_dir),
         "--top-k", "3"], env=env, cwd=tmp_path, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip("\n") == got.rstrip("\n")
