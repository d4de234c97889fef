"""The port's data platform, filled from the benchmark's traffic generator.

``ProductionSim`` supplies the stores, the compaction pipeline and the
snapshotter. Its event stream is the
benchmark's ``reference.events.EventStream``, so the port's ingestion and
compaction read the benchmark's events; the request schedule is the
benchmark's too, driven through the snapshotter by a copy of
``ProductionSim.issue_requests``'s loop.
"""
from __future__ import annotations

import numpy as np

from bench.reference.events import (
    MS_PER_DAY,
    EventStream,
    StreamParams,
    day_requests,
)


def stream_params(traffic: dict, seed: int) -> StreamParams:
    s = traffic["sim"]
    return StreamParams(n_users=s["n_users"], n_items=s["n_items"],
                        days=s["days"] + 1,
                        events_per_user_day_mean=s["events_per_user_day_mean"],
                        seed=seed)


def request_rng(seed: int) -> np.random.Generator:
    """The request schedule's generator (independent of the event draws)."""
    return np.random.default_rng((seed, 1))


def build_sim(traffic: dict, seed: int):
    """The port's ``ProductionSim`` after ``traffic["sim"]["days"]`` days
    of compaction, ingestion and requests, each request logged as a
    versioned training example. ``SimConfig`` ties the immutable tier's
    retention to the snapshotter's lookback; the mix keeps
    ``retention_days`` instead, by a compaction pipeline of its own, so
    that every logged window stays in the live generation for the whole
    run. The example stream and the warehouse are not filled: a
    ``SimSource`` feed reads neither."""
    from repro_torch.core.simulation import ProductionSim, SimConfig
    from repro_torch.core import events as ev
    from repro_torch.storage.compaction import (CompactionConfig,
                                                CompactionPipeline)

    s = traffic["sim"]
    params = stream_params(traffic, seed)
    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=s["n_users"], n_items=s["n_items"],
                               days=s["days"] + 1,
                               events_per_user_day_mean=s[
                                   "events_per_user_day_mean"], seed=seed),
        stripe_len=s["stripe_len"],
        requests_per_user_day=s["requests_per_user_day"],
        lookback_ms=s["lookback_days"] * MS_PER_DAY, seed=seed))
    sim.compactor = CompactionPipeline(sim.schema, CompactionConfig(
        stripe_len=s["stripe_len"],
        lookback_ms=s["retention_days"] * MS_PER_DAY))
    sim.events = EventStream(params)
    rng = request_rng(seed)
    for day in range(s["days"]):
        watermark = day * MS_PER_DAY - 1
        if watermark > 0:
            sim.run_compaction(watermark)
        sim.ingest_day_events(day)
        for r in day_requests(rng, day, s["n_users"], s["n_items"],
                              s["requests_per_user_day"]):
            sim.examples.append(sim.snapshotter.snapshot(
                r.user_id, r.request_ts, {"item_id": r.cand_item_id},
                {"click": r.click}, label_ts=r.request_ts + 60_000))
        sim.current_day = day
    return sim
