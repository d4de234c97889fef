"""End-to-end production lifecycle simulation.

Drives the full loop of Fig. 1 / Fig. 3 over synthetic traffic:

  day d:   user events arrive -> blind-write appends into the mutable tier
  daily:   offloaded compaction consolidates history <= watermark into the
           immutable tier (bulk load), mutable tier evicts <= watermark
  online:  ranking requests fire at T_request -> snapshotter assembles UIH from
           both tiers, logs a training example (VLM: mutable slice + version
           metadata; baseline: Fat Row) -> published to the stream and ingested
           into hourly warehouse partitions

Used by the consistency tests (ground-truth inference UIH is captured at
request time) and by the Table-1/Fig-2 benchmarks (byte accounting).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import events as ev
from repro_torch.core.materialize import Materializer
from repro_torch.core.snapshot import (
    BaseSnapshotter,
    FatRowSnapshotter,
    SnapshotterConfig,
    VLMSnapshotter,
)
from repro_torch.core.versioning import TrainingExample
from repro_torch.storage.compaction import CompactionConfig, CompactionPipeline, ScrubFn
from repro_torch.storage.immutable_store import ImmutableUIHStore
from repro_torch.storage.mutable_store import MutableUIHStore
from repro_torch.storage.protocol import StoreProtocol
from repro_torch.storage.sharded_store import ShardedUIHStore
from repro_torch.storage.stream import TrainingExampleStream, Warehouse


@dataclasses.dataclass
class SimConfig:
    stream: ev.StreamConfig = dataclasses.field(default_factory=ev.StreamConfig)
    stripe_len: int = 64
    requests_per_user_day: int = 4
    lookback_ms: int = 30 * ev.MS_PER_DAY
    n_shards: int = 8
    n_buckets: int = 8
    mode: str = "vlm"  # "vlm" | "fatrow"
    seed: int = 0
    # Bifurcated-protocol generation pinning: published stream examples hold a
    # lease on the generation their version metadata references until a
    # streaming consumer acks them (repro.streaming). Opt-in: batch-only
    # workloads never ack, so pinning would retain one superseded generation
    # per compaction cycle for the whole run.
    pin_generations: bool = False
    # Disaggregated immutable tier: 0 = in-process monolith (the default every
    # existing scenario runs on); N>0 = ShardedUIHStore client over N store
    # nodes with length-aware heavy-tail placement (DESIGN.md §11).
    n_store_nodes: int = 0
    placement_policy: str = "length_aware"  # "length_aware" | "hash"
    # Replicated tier (DESIGN.md §12): r-way replication with health-aware
    # failover; hedge_quantile > 0 arms speculative replica reads once a
    # request outlives the tier's latency quantile. Monolith sims ignore both.
    replication_factor: int = 1
    hedge_quantile: float = 0.0


class ProductionSim:
    def __init__(self, cfg: SimConfig, schema: Optional[ev.TraitSchema] = None):
        self.cfg = cfg
        self.schema = schema or ev.default_schema()
        self.events = ev.SyntheticEventStream(cfg.stream, self.schema)
        self.mutable = MutableUIHStore(self.schema)
        if cfg.n_store_nodes > 0:
            self.immutable: StoreProtocol = ShardedUIHStore(
                self.schema, n_shards=cfg.n_shards,
                n_nodes=cfg.n_store_nodes,
                placement_policy=cfg.placement_policy,
                replication_factor=cfg.replication_factor,
                hedge_quantile=cfg.hedge_quantile)
        else:
            self.immutable = ImmutableUIHStore(
                self.schema, n_shards=cfg.n_shards)
        self.compactor = CompactionPipeline(
            self.schema,
            CompactionConfig(stripe_len=cfg.stripe_len, lookback_ms=cfg.lookback_ms),
        )
        snap_cfg = SnapshotterConfig(lookback_ms=cfg.lookback_ms)
        snap_cls = VLMSnapshotter if cfg.mode == "vlm" else FatRowSnapshotter
        self.snapshotter: BaseSnapshotter = snap_cls(
            self.mutable, self.immutable, self.schema, snap_cfg
        )
        self.stream = TrainingExampleStream(
            self.schema, capacity=1 << 20,
            lease_manager=self.immutable if cfg.pin_generations else None)
        self.warehouse = Warehouse(self.schema, n_buckets=cfg.n_buckets)
        self.examples: List[TrainingExample] = []
        self.references: List[ev.EventBatch] = []  # inference-time ground truth
        self._rng = np.random.default_rng(cfg.seed)
        self.current_day = -1
        # the compaction pipeline is a singleton in production; serializing it
        # here keeps generation-id allocation race-free when stress tests run
        # extra compaction churn concurrently with the daily cycle
        self._compaction_lock = threading.Lock()
        self.compaction_watermark = -1   # monotone: never regresses
        # optional: label_fn(inference_uih, candidate, rng) -> labels dict,
        # letting benchmarks synthesize labels that depend on long history
        self.label_fn = None

    # -- lifecycle -------------------------------------------------------------
    def _source_of_truth(self, user_id: int, t_lo: int, t_hi: int) -> ev.EventBatch:
        hist = self.events.history_until(user_id, t_hi)
        return ev.time_slice(hist, t_lo, t_hi)

    def run_compaction(self, as_of_ts: int, scrub: Optional[ScrubFn] = None,
                       evict: bool = True):
        """One compaction cycle: rebuild + bulk-load a new generation, then
        (optionally) evict the consolidated prefix from the mutable tier.
        ``evict=False`` is for re-compactions at an ALREADY-evicted watermark
        (generation churn): logically a no-op eviction, skipping it avoids
        rewriting chunk lists under concurrent ingestion."""
        users = range(self.cfg.stream.n_users)
        with self._compaction_lock:
            # watermark monotonicity: a re-run (or concurrent churn cycle) at
            # a stale watermark must not REGRESS the serving watermark — the
            # mutable tier has already evicted up to the established one, so a
            # regressed generation would lose the gap for every new snapshot
            as_of_ts = max(as_of_ts, self.compaction_watermark)
            report = self.compactor.run(
                self._source_of_truth, list(users), as_of_ts, self.immutable,
                scrub=scrub
            )
            self.compaction_watermark = as_of_ts
            if evict:
                self.mutable.evict_all_until(as_of_ts)
        return report

    def ingest_day_events(self, day: int) -> None:
        """Events arrive throughout the day as blind-write appends."""
        for uid in range(self.cfg.stream.n_users):
            batch = self.events.day_events(uid, day)
            n = ev.batch_len(batch)
            if n == 0:
                continue
            # split into a few out-of-order chunks to exercise blind writes
            n_chunks = min(3, n)
            splits = np.array_split(np.arange(n), n_chunks)
            order = self._rng.permutation(n_chunks)
            for c in order:
                self.mutable.append(uid, ev.take_batch(batch, splits[c]))

    def issue_requests(self, day: int, capture_reference: bool = True) -> None:
        """Ranking requests at random times within the day; snapshot + ingest."""
        cfg = self.cfg
        # requests from different users interleave in arrival (time) order,
        # as they would on a production stream
        pairs = []
        for uid in range(cfg.stream.n_users):
            # requests arrive in SESSIONS: bursts inside the same hour (this is
            # what makes user-bucketed hourly warehouse clustering effective)
            n = cfg.requests_per_user_day
            n_sessions = max(1, min(2, n // 2))
            starts = self._rng.integers(
                day * ev.MS_PER_DAY + 1_000_000,
                (day + 1) * ev.MS_PER_DAY - 3_600_000,
                size=n_sessions,
            )
            per = int(np.ceil(n / n_sessions))
            times = []
            for st in starts:
                times.extend(
                    int(st) + int(o)
                    for o in np.sort(self._rng.integers(0, 3_500_000, size=per))
                )
            pairs.extend((t, uid) for t in times[:n])
        pairs.sort()
        for t, uid in pairs:
                candidate = {"item_id": int(self._rng.integers(0, cfg.stream.n_items))}
                if self.label_fn is not None:
                    candidate["category"] = int(
                        self.events._item_category[candidate["item_id"]])
                    # labels derive from the inference-time UIH: use the SAME
                    # fetch for labels, example, and reference (a second fetch
                    # could land on the other side of a generation flip)
                    exm, ref = self.snapshotter.snapshot_with_reference(
                        uid, t, candidate, label_ts=t + 60_000,
                        labels_fn=lambda uih: self.label_fn(
                            uih, candidate, self._rng))
                    if capture_reference:
                        self.references.append(ref)
                elif capture_reference:
                    labels = {"click": float(self._rng.random() < 0.1)}
                    # example + reference from ONE two-tier fetch: the pair is
                    # consistent even when compaction flips the generation
                    # between requests (streaming stress tests rely on this)
                    exm, ref = self.snapshotter.snapshot_with_reference(
                        uid, t, candidate, labels, label_ts=t + 60_000)
                    self.references.append(ref)
                else:
                    labels = {"click": float(self._rng.random() < 0.1)}
                    exm = self.snapshotter.snapshot(uid, t, candidate, labels,
                                                    label_ts=t + 60_000)
                self.examples.append(exm)
                self.stream.publish(exm)
        self.warehouse.ingest(self.examples[-cfg.stream.n_users * cfg.requests_per_user_day:])

    def run_day(self, day: int, capture_reference: bool = True) -> None:
        """One production day: compaction of history < day, then live traffic."""
        # daily compaction consolidates everything strictly before this day
        watermark = day * ev.MS_PER_DAY - 1
        if watermark > 0:
            self.run_compaction(watermark)
        self.ingest_day_events(day)
        self.issue_requests(day, capture_reference=capture_reference)
        self.current_day = day

    def run_days(self, n_days: int, capture_reference: bool = True) -> None:
        for d in range(n_days):
            self.run_day(d, capture_reference=capture_reference)

    # -- verification hooks ------------------------------------------------------
    def materializer(self, validate_checksum: bool = True,
                     pin_generations: bool = False) -> Materializer:
        return Materializer(
            self.immutable, self.schema, validate_checksum=validate_checksum,
            pin_generations=pin_generations,
        )
