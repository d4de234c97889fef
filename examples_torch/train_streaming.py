"""Online streaming training driver on the PyTorch port: the "O" in O2O,
end to end.

  warehouse backfill (catch-up) -> flip to live stream (exactly-once watermark)
  -> micro-batched DPP materialization with generation-pinned windows
  -> slot-based rebatching -> device prefetch -> DLRM-UIH trainer

while LIVE traffic keeps arriving AND daily compaction publishes new
immutable generations underneath — the generation-lease protocol keeps every
materialized window byte-exact to what the ranking service saw.

The whole pipeline is ONE declarative spec: the same ``DatasetSpec`` ->
``open_feed`` -> ``Feed`` path the batch driver uses, with
``source=StreamSource(...)`` and ``generations="pinned"``.

Run:  PYTHONPATH=src python examples_torch/train_streaming.py
          [--live-days 2] [--device cpu]

Port of ``examples/train_streaming.py``: the same flags, defaults, sim
seed, spec, model and printed lines; ``--device`` is ``cuda`` unless the
caller asks for ``cpu`` (no fallback). Streamed batches are densified on
the host, as in the reference, and the device-prefetch stage copies them
to the device. The feed is opened while the warehouse head is the sealed
history, and the producer of the live days starts after it, as the
backfill's hour range requires (``repro_torch.streaming.backfill``).
"""
import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.projection import TenantProjection
from repro_torch.core.simulation import ProductionSim, SimConfig
from repro_torch.data import DatasetSpec, StreamSource, open_feed
from repro_torch.device import resolve_device
from repro_torch.dpp.featurize import FeatureSpec
from repro_torch.models import recsys as R
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import Trainer, TrainerConfig

SEQ_LEN = 48
BATCH = 32

MODEL = R.DLRMUIHConfig(
    name="seqrec-online", seq_len=SEQ_LEN, d_seq=32, n_seq_layers=2,
    n_heads=4, n_dense=4, n_sparse=2, embed_dim=16, item_vocab=4_096,
    field_vocab=4_096, compute_dtype=torch.float32, remat=False)


def build_sim(history_days: int, live_days: int) -> ProductionSim:
    """The generation-pinned sim, its history phase run: the warehouse
    head is sealed before the coordinator forms."""
    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(
            n_users=24, n_items=4_000,
            days=history_days + live_days + 1,
            events_per_user_day_mean=40.0, seed=0),
        stripe_len=32, requests_per_user_day=6, seed=0,
        pin_generations=True))
    sim.run_days(history_days, capture_reference=False)
    return sim


def dataset_spec() -> DatasetSpec:
    tenant = TenantProjection(
        "dlrm-uih", seq_len=SEQ_LEN,
        feature_groups=("core", "sideinfo"),
        traits_per_group={"core": ("timestamp", "item_id", "action_type"),
                          "sideinfo": ("category",)})
    return DatasetSpec(
        tenant=tenant,
        source=StreamSource(backfill=True, micro_batch_examples=8,
                            micro_batch_delay_s=0.05),
        consistency="audit",        # checksum-validate every full window (O2O)
        generations="pinned",       # scan the logged (leased) generation
        batch_size=BATCH, prefetch_depth=2, n_workers=2,
        window_cache_size=256,
        features=FeatureSpec(seq_len=SEQ_LEN,
                             uih_traits=("item_id", "action_type", "category"),
                             candidate_fields=("item_id",),
                             label_fields=("click",)))


def prep(b, cfg=MODEL):
    return {
        "uih_item_id": (b["uih_item_id"] % cfg.item_vocab).astype(np.int32),
        "uih_action_type": (b["uih_action_type"] % 16).astype(np.int32),
        "uih_mask": b["uih_mask"],
        "cand_item_id": (b["cand_item_id"] % cfg.item_vocab).astype(np.int32),
        "sparse_ids": np.stack([b["user_id"] % cfg.field_vocab,
                                b["cand_item_id"] % cfg.field_vocab],
                               1).astype(np.int32),
        "dense": np.stack([b["uih_mask"].sum(1)] * 4, 1).astype(np.float32)
        / SEQ_LEN,
        "label": b["label_click"].astype(np.float32),
    }


def start_producer(sim: ProductionSim, history_days: int,
                   live_days: int) -> threading.Thread:
    """Run the live days on a thread, closing the stream at the end."""
    def producer():
        try:
            for day in range(history_days, history_days + live_days):
                sim.run_day(day, capture_reference=False)
        finally:
            sim.stream.close()

    prod = threading.Thread(target=producer, daemon=True)
    prod.start()
    return prod


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--history-days", type=int, default=2,
                    help="warehouse days replayed by the catch-up backfill")
    ap.add_argument("--live-days", type=int, default=2,
                    help="days of live traffic consumed after the flip")
    ap.add_argument("--max-wall-s", type=float, default=120.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the example; returns the printed counts."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    sim = build_sim(args.history_days, args.live_days)
    print(f"history: {len(sim.examples)} examples across "
          f"{len(sim.warehouse.hours())} warehouse hours, "
          f"immutable generation {sim.immutable.generation}")
    cfg = MODEL
    params = R.init_dlrm_uih(cfg, seed=0, device=device)
    trainer = Trainer(
        lambda p, b: R.dlrm_uih_loss(p, b, cfg), params,
        TrainerConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=20,
                                      total_steps=10_000),
                      grad_accum=2, log_every=20,
                      max_wall_s=args.max_wall_s))

    feed = open_feed(dataset_spec(), sim, device=device, prep_fn=prep)
    prod = start_producer(sim, args.history_days, args.live_days)
    t0 = time.perf_counter()
    trainer.fit(feed)   # runs until the stream drains (or max_wall_s)
    dt = time.perf_counter() - t0
    # close() (not join()): if the wall bound fired first, the remaining
    # stream must be drained untrained so blocked workers can shut down
    feed.close()
    prod.join()

    session = feed.session
    bf = session.backfill_stats
    st = feed.stats()
    fr, cs = st.freshness, st.client
    ls = sim.immutable.lease_stats
    total = len(sim.examples)
    print(f"\ntrained {trainer.step} steps in {dt:.1f}s "
          f"({trainer.step / dt:.1f} steps/s)")
    print(f"catch-up handoff: {bf.warehouse_examples} from warehouse "
          f"(watermark={bf.watermark}), {bf.stream_examples} live, "
          f"{bf.duplicates_skipped} stream duplicates skipped "
          f"-> {bf.warehouse_examples + bf.stream_examples}/{total} "
          f"trained exactly once")
    print(f"freshness: event->gradient mean "
          f"{fr.mean_event_to_gradient_s * 1e3:.0f}ms, max "
          f"{fr.event_to_gradient_s_max * 1e3:.0f}ms "
          f"({fr.samples} live rows); stream lag peak "
          f"{session.source.stats.max_lag}")
    print(f"generations: live={sim.immutable.generation}, leases "
          f"{ls.acquired} acquired / {ls.released} released, "
          f"{ls.generations_retained} retained / {ls.generations_gc} GC'd")
    ws = st.workers
    mats = [w.materializer for w in session.pool._workers]
    pinned = sum(m.stats.pinned_windows for m in mats)
    stale = sum(m.stats.stale_reresolved for m in mats)
    fails = sum(m.stats.stale_failures for m in mats)
    print(f"materialization: {ws.examples} examples, {pinned} pinned windows, "
          f"{stale} stale re-resolved, {fails} failures; "
          f"feed starvation {cs.starvation_pct:.1f}%")
    return {"steps": trainer.step, "seconds": dt, "total": total,
            "warehouse_examples": bf.warehouse_examples,
            "stream_examples": bf.stream_examples,
            "leases_acquired": ls.acquired, "leases_released": ls.released,
            "leased": sim.immutable.leased_generations(),
            "examples_trained": ws.examples, "stale_failures": fails,
            "losses": [h["loss"] for h in trainer.history]}


if __name__ == "__main__":
    main()
