"""DPP worker (paper §4.2.1-4.2.2): the vectorized query-engine operator.

A worker executes the specialized index join — probe side = primary training
examples, build side = the immutable UIH store — then featurizes the result
into a *base batch* sized to fit the worker's memory budget. Pipelined I/O
prefetching overlaps the immutable lookup for batch N with the probe-side read
for batch N+1.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core import events as ev
from repro_torch.core.materialize import Materializer
from repro_torch.core.projection import TenantProjection
from repro_torch.core.versioning import TrainingExample
from repro_torch.dpp.featurize import (
    FeatureSpec,
    JaggedFeatures,
    featurize,
    featurize_jagged,
)
from repro_torch.obs.spans import current_span

ProbeFn = Callable[[int], Optional[List[TrainingExample]]]  # batch idx -> examples


@dataclasses.dataclass
class WorkerPlan:
    """Spec-compiled read plan for one worker: everything a ``DPPWorker``
    needs, bundled by the declarative compiler (``repro.data.open_feed``) so
    pipelines stop hand-wiring (materializer, projection, feature spec,
    schema) at every call site. ``make_materializer`` is a factory because
    materializers are thread-local by design (window cache + IO accounting):
    each pool worker gets its own."""

    projection: TenantProjection
    feature_spec: FeatureSpec
    schema: ev.TraitSchema
    make_materializer: Callable[[], Materializer]
    probe_latency_s: float = 0.0


class _ProbeError:
    """Exception captured in the probe producer thread, re-raised consumer-side."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclasses.dataclass
class WorkerStats:
    base_batches: int = 0
    examples: int = 0
    probe_time_s: float = 0.0     # primary training-table read
    lookup_time_s: float = 0.0    # immutable UIH multi-range scan
    featurize_time_s: float = 0.0
    total_time_s: float = 0.0
    # planned-scan savings, accumulated from the store's IOStats per lookup
    dedup_hits: int = 0           # requests answered by an in-plan twin
    decode_cache_hits: int = 0    # stripe decodes served from the decode LRU
    parallel_shards: int = 0      # cumulative shard fanout of batched scans
    # self-healing (pool-level recovery, merged in by merged_worker_stats)
    worker_restarts: int = 0      # workers that died mid-item and were replaced
    items_requeued: int = 0       # work items re-dispatched after a crash
    lease_recoveries: int = 0     # generation leases released by crash recovery

    @property
    def busy_time_s(self) -> float:
        return self.probe_time_s + self.lookup_time_s + self.featurize_time_s

    @property
    def waste_pct(self) -> float:
        """CPU idle share of wall time (paper's 'worker waste percentage')."""
        if self.total_time_s <= 0:
            return 0.0
        return max(0.0, 1.0 - self.busy_time_s / self.total_time_s) * 100.0


class DPPWorker:
    def __init__(
        self,
        materializer: Materializer,
        projection: TenantProjection,
        feature_spec: FeatureSpec,
        schema: ev.TraitSchema,
        probe_latency_s: float = 0.0,   # emulated primary-table read latency
    ):
        self.materializer = materializer
        self.projection = projection
        self.feature_spec = feature_spec
        self.schema = schema
        self.probe_latency_s = probe_latency_s
        self.stats = WorkerStats()

    @classmethod
    def from_plan(cls, plan: WorkerPlan) -> "DPPWorker":
        """Build a worker from a spec-compiled ``WorkerPlan`` (fresh
        materializer per call: thread-local by design)."""
        return cls(plan.make_materializer(), plan.projection,
                   plan.feature_spec, plan.schema,
                   probe_latency_s=plan.probe_latency_s)

    # -- single base batch -----------------------------------------------------
    def _lookup(self, examples: List[TrainingExample]) -> List[ev.EventBatch]:
        t0 = time.perf_counter()
        # materializer-local IO accounting: the store's global stats are
        # shared across workers, so deltas of them would mix in other
        # workers' concurrent traffic
        before = self.materializer.io_stats.snapshot()
        uihs = self.materializer.materialize_batch(examples, self.projection)
        d = self.materializer.io_stats.delta(before)
        self.stats.dedup_hits += d.dedup_hits
        self.stats.decode_cache_hits += d.decode_cache_hits
        self.stats.parallel_shards += d.parallel_shards
        t1 = time.perf_counter()
        self.stats.lookup_time_s += t1 - t0
        sp = current_span()
        if sp is not None:
            # decode runs on store-internal shard threads, so it folds into
            # the scan stage; the IOStats delta keeps its weight visible
            sp.stage("scan", t0, t1)
            sp.meta["bytes_scanned"] = sp.meta.get("bytes_scanned", 0) + d.bytes_scanned
            sp.meta["bytes_decoded"] = sp.meta.get("bytes_decoded", 0) + d.bytes_decoded
        return uihs

    def _featurize(self, examples, uihs) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        out = featurize(examples, uihs, self.feature_spec)
        t1 = time.perf_counter()
        self.stats.featurize_time_s += t1 - t0
        self.stats.base_batches += 1
        self.stats.examples += len(examples)
        sp = current_span()
        if sp is not None:
            sp.stage("featurize", t0, t1)
        return out

    def process(self, examples: List[TrainingExample]) -> Dict[str, np.ndarray]:
        return self._featurize(examples, self._lookup(examples))

    def process_jagged(self, examples: List[TrainingExample]) -> JaggedFeatures:
        """Materialize + featurize into the arena+offsets form, skipping the
        [B, L] densification — ``RebatchingClient.put_jagged`` scatters the
        arena straight into the slot (one copy instead of three)."""
        uihs = self._lookup(examples)
        t0 = time.perf_counter()
        out = featurize_jagged(examples, uihs, self.feature_spec)
        t1 = time.perf_counter()
        self.stats.featurize_time_s += t1 - t0
        self.stats.base_batches += 1
        self.stats.examples += len(examples)
        sp = current_span()
        if sp is not None:
            sp.stage("featurize", t0, t1)
        return out

    def _probe(self, probe: ProbeFn, idx: int) -> Optional[List[TrainingExample]]:
        t0 = time.perf_counter()
        out = probe(idx)
        if self.probe_latency_s and out is not None:
            time.sleep(self.probe_latency_s)
        self.stats.probe_time_s += time.perf_counter() - t0
        return out

    # -- serial execution (baseline for the prefetch benchmark) -----------------
    def run_serial(self, probe: ProbeFn) -> Iterator[Dict[str, np.ndarray]]:
        t_start = time.perf_counter()
        idx = 0
        while True:
            examples = self._probe(probe, idx)
            if examples is None:
                break
            uihs = self._lookup(examples)
            yield self._featurize(examples, uihs)
            idx += 1
        self.stats.total_time_s += time.perf_counter() - t_start

    # -- pipelined execution (paper §4.2.2) --------------------------------------
    def run_pipelined(self, probe: ProbeFn) -> Iterator[Dict[str, np.ndarray]]:
        """Overlap the immutable-store lookup for batch N with the probe-side
        read for batch N+1 using a single prefetch thread (double buffering).

        A probe failure in the producer thread is captured and re-raised here —
        a daemon thread dying silently would otherwise leave the consumer
        blocked on ``probe_q.get()`` forever."""
        t_start = time.perf_counter()
        probe_q: "queue.Queue" = queue.Queue(maxsize=2)

        def producer():
            idx = 0
            while True:
                try:
                    examples = self._probe(probe, idx)
                except BaseException as e:
                    probe_q.put(_ProbeError(e))
                    return
                probe_q.put(examples)
                if examples is None:
                    return
                idx += 1

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                examples = probe_q.get()
                if isinstance(examples, _ProbeError):
                    raise RuntimeError("probe producer failed") from examples.exc
                if examples is None:
                    break
                uihs = self._lookup(examples)
                yield self._featurize(examples, uihs)
            th.join()
        finally:
            self.stats.total_time_s += time.perf_counter() - t_start


def probe_from_list(
    examples: Sequence[TrainingExample], base_batch_size: int
) -> ProbeFn:
    def probe(idx: int) -> Optional[List[TrainingExample]]:
        lo = idx * base_batch_size
        if lo >= len(examples):
            return None
        return list(examples[lo : lo + base_batch_size])

    return probe
