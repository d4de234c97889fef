"""Streaming training throughput + freshness while compaction cycles (§3.2).

Measures the online half of the bifurcated protocol end-to-end: a producer
runs live traffic days (each with its daily compaction) PLUS an extra
generation-churn thread re-compacting the established watermark, while a
``StreamingSession`` backfills the warehouse, flips to the live stream with
the exactly-once watermark, and materializes generation-pinned windows into
full batches. Reported:

  * ``streaming_sustained`` — full-batch cadence; derived: rows/s, event->
    gradient freshness (mean/max ms), generation flips survived, pinned vs
    re-resolved window counts, checksum failures (must be 0);
  * ``streaming_handoff`` — warehouse catch-up replay rate and the flip's
    exactly-once accounting (duplicates skipped, watermark).

Port of ``benchmarks/bench_streaming.py`` over the port's
``StreamingSession``. One departure lies in the module under test, not
here: the port's session holds a window's generation lease across the
flip while a replayed copy is in flight (``repro_torch.streaming``).
Host-only: nothing reaches the card.
"""
from __future__ import annotations

import threading
import time

from benchmarks_torch.common import BenchResult
from repro_torch.core import events as ev
from repro_torch.core.projection import TenantProjection
from repro_torch.core.simulation import ProductionSim, SimConfig
from repro_torch.dpp.featurize import FeatureSpec
from repro_torch.dpp.worker import DPPWorker
from repro_torch.streaming import MicroBatchConfig, StreamingSession

SEQ_LEN = 32


def run(quick: bool = False):
    users, hist_days, live_days, req = (6, 1, 1, 3) if quick else (24, 2, 2, 6)
    batch = 16 if quick else 32
    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(
            n_users=users, n_items=4_000, days=hist_days + live_days + 1,
            events_per_user_day_mean=15.0 if quick else 40.0, seed=7),
        stripe_len=32, requests_per_user_day=req, seed=7,
        pin_generations=True))
    sim.run_days(hist_days, capture_reference=False)
    n_history = len(sim.examples)

    tenant = TenantProjection(
        "bench", seq_len=SEQ_LEN, feature_groups=("core", "sideinfo"),
        traits_per_group={"core": ("timestamp", "item_id", "action_type"),
                          "sideinfo": ("category",)})
    spec = FeatureSpec(seq_len=SEQ_LEN,
                       uih_traits=("item_id", "action_type", "category"),
                       candidate_fields=("item_id",), label_fields=("click",))

    def make_worker():
        mat = sim.materializer(validate_checksum=True, pin_generations=True)
        mat.window_cache_size = 128
        return DPPWorker(mat, tenant, spec, sim.schema)

    session = StreamingSession(
        sim.stream, make_worker, full_batch_size=batch,
        micro_batch=MicroBatchConfig(max_examples=8, max_delay_s=0.02),
        n_workers=2, backfill_from=sim.warehouse).start()

    gen_start = sim.immutable.generation
    stop = threading.Event()

    def churn():
        # generation churn under the in-flight stream: re-compact the
        # established watermark (identical content, new generation id)
        while not stop.is_set():
            if sim.compaction_watermark >= 0:
                sim.run_compaction(sim.compaction_watermark, evict=False)
            time.sleep(0.01)

    def producer():
        try:
            for day in range(hist_days, hist_days + live_days):
                sim.run_day(day, capture_reference=False)
        finally:
            sim.stream.close()

    churn_th = threading.Thread(target=churn, daemon=True)
    prod = threading.Thread(target=producer, daemon=True)
    churn_th.start()
    prod.start()

    t0 = time.perf_counter()
    rows = 0
    batches = 0
    backfill_done_t = None
    for b in session:
        batches += 1
        rows += len(b["uih_len"])
        if backfill_done_t is None and session.backfill_stats.flipped:
            backfill_done_t = time.perf_counter()
        session.record_train_step(0.0005)   # stand-in train step
        session.recycle(b)
    wall = time.perf_counter() - t0
    session.join()
    prod.join()
    stop.set()
    churn_th.join()

    bf = session.backfill_stats
    fr = session.freshness
    mats = [w.materializer for w in session.pool._workers]
    pinned = sum(m.stats.pinned_windows for m in mats)
    stale = sum(m.stats.stale_reresolved for m in mats)
    failures = sum(m.stats.stale_failures + m.stats.checksum_failures
                   for m in mats)
    flips = sim.immutable.generation - gen_start
    total = len(sim.examples)
    assert bf.warehouse_examples + bf.stream_examples == total, "lost examples"
    assert failures == 0, "stale remediation failed"

    results = [
        BenchResult(
            "streaming_sustained",
            us_per_call=wall / max(batches, 1) * 1e6,
            derived={
                "rows_per_s": round(rows / wall, 1),
                "rows": rows,
                "event_to_gradient_ms_mean":
                    round(fr.mean_event_to_gradient_s * 1e3, 1),
                "event_to_gradient_ms_max":
                    round(fr.event_to_gradient_s_max * 1e3, 1),
                "gen_flips": flips,
                "pinned_windows": pinned,
                "stale_reresolved": stale,
                "window_failures": failures,
                "leases_gc": sim.immutable.lease_stats.generations_gc,
                "peak_stream_lag": session.source.stats.max_lag,
            },
        ),
        BenchResult(
            "streaming_handoff",
            us_per_call=(
                ((backfill_done_t or t0) - t0) / max(n_history, 1) * 1e6),
            derived={
                "warehouse_examples": bf.warehouse_examples,
                "stream_examples": bf.stream_examples,
                "duplicates_skipped": bf.duplicates_skipped,
                "watermark": bf.watermark,
                "hours_replayed": bf.hours_replayed,
                "empty_hours": bf.empty_hours,
                "exactly_once": int(
                    bf.warehouse_examples + bf.stream_examples == total),
            },
        ),
    ]
    return results


if __name__ == "__main__":
    for r in run():
        print(r.csv())
