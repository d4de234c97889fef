"""Real-time training-example stream + hourly warehouse ingestion (paper §3.2).

Online streaming training consumes a real-time messaging stream; the same
stream is persisted into hourly warehouse partitions for batch training. During
warehouse ingestion, examples are clustered into **user-keyed buckets** inside
each hourly partition (data-affinity optimization, §4.2.3) so that DPP workers
can amortize one immutable-sequence lookup across a user's temporally-adjacent
examples.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, Iterator, List, Optional, Sequence

from repro_torch.core import events as ev
from repro_torch.core.versioning import TrainingExample
from repro_torch.storage.sharding import shard_of

MS_PER_HOUR = 3_600_000


class StreamDisconnect(ConnectionError):
    """Transient consumer-side stream failure (broker hiccup, network blip).

    The broker retains unacked messages across a disconnect, so consumers
    recover by reconnecting and re-polling — nothing is lost or duplicated.
    ``StreamingSource`` heals this in place (``SourceStats.reconnects``);
    ``repro_torch.testing.FaultyStream`` injects it deterministically."""


class TrainingExampleStream:
    """Bounded in-memory FIFO modelling the distributed messaging stream.

    Thread-safe: the ingestion service publishes, streaming DPP workers consume.
    Byte accounting measures the stream write bandwidth (Table 1 'primary
    write').

    **Generation pinning** (bifurcated protocol, §3.2): when constructed with a
    ``lease_manager`` (the ``ImmutableUIHStore``), every published VLM example
    acquires a refcounted lease on the generation its version metadata
    references, so daily compaction cannot GC that generation while the
    example is in flight. The consumer releases the lease via ``ack()`` once
    the example has been materialized (drained). An acquire that races a
    compaction losing the generation is counted in ``lease_misses`` — the
    materializer's stale-generation remediation covers that example instead.
    """

    def __init__(self, schema: ev.TraitSchema, capacity: int = 1 << 16,
                 lease_manager=None):
        self.schema = schema
        self._q: Deque[TrainingExample] = collections.deque()
        self._cv = threading.Condition()
        self.capacity = capacity
        self.bytes_published = 0
        self.examples_published = 0
        self._closed = False
        # generation pinning + publish-time wall clocks (freshness metrics)
        self.lease_manager = lease_manager
        self._leases: Dict[int, object] = {}      # request_id -> GenerationLease
        self._pub_wall: Dict[int, float] = {}     # request_id -> publish wall time
        # flipped on by an attaching StreamingSource: publish-time clocks are
        # only recorded (and popped) when a streaming consumer exists — a
        # batch-only publisher must not accrete them
        self.track_freshness = False
        self.leases_acquired = 0
        self.lease_misses = 0
        self.acked = 0

    def publish(self, example: TrainingExample) -> None:
        blob_len = example.payload_bytes(self.schema)
        lease = None
        if (self.lease_manager is not None and example.version is not None
                and example.version.generation >= 0):
            try:
                lease = self.lease_manager.acquire_lease(
                    example.version.generation)
            except KeyError:       # gen GC'd between snapshot and publish:
                self.lease_misses += 1  # remediation re-resolves downstream
        with self._cv:
            while len(self._q) >= self.capacity and not self._closed:
                self._cv.wait()
            if self._closed:
                if lease is not None:
                    lease.release()
                raise RuntimeError("stream closed")
            self._q.append(example)
            if lease is not None:
                self._leases[example.request_id] = lease
                self.leases_acquired += 1
            if self.track_freshness:
                self._pub_wall[example.request_id] = time.perf_counter()
            self.bytes_published += blob_len
            self.examples_published += 1
            self._cv.notify_all()

    def consume(self, timeout: Optional[float] = None) -> Optional[TrainingExample]:
        """Next example, or ``None`` — which means EITHER the wait timed out OR
        the stream is closed and fully drained; disambiguate via ``drained``."""
        with self._cv:
            while not self._q and not self._closed:
                if not self._cv.wait(timeout=timeout):
                    return None
            if not self._q:
                return None
            out = self._q.popleft()
            self._cv.notify_all()
            return out

    @property
    def drained(self) -> bool:
        """True iff the stream is closed AND every example has been consumed —
        the unambiguous end-of-stream signal (``consume`` returning ``None``
        alone cannot distinguish a timeout from exhaustion)."""
        with self._cv:
            return self._closed and not self._q

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def lag(self) -> int:
        """Examples published but not yet consumed (stream backlog)."""
        with self._cv:
            return len(self._q)

    def publish_wall(self, request_id: int) -> Optional[float]:
        """Pop the wall-clock publish time of a consumed example (freshness)."""
        return self._pub_wall.pop(request_id, None)

    def ack(self, example) -> None:
        """Release the generation lease of a drained example (id or example)."""
        rid = getattr(example, "request_id", example)
        lease = self._leases.pop(rid, None)
        if lease is not None:
            lease.release()
            self.acked += 1

    def pending_leases(self) -> int:
        return len(self._leases)

    def release_leases(self) -> int:
        """Drop every outstanding lease (shutdown path). Returns the count."""
        n = 0
        while self._leases:
            try:
                _, lease = self._leases.popitem()
            except KeyError:
                break
            lease.release()
            n += 1
        return n

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __iter__(self) -> Iterator[TrainingExample]:
        while True:
            ex = self.consume()
            if ex is None:
                return
            yield ex


@dataclasses.dataclass
class WarehousePartition:
    hour: int
    # bucket id -> serialized examples (user-clustered)
    buckets: Dict[int, List[bytes]]

    def examples_bytes(self) -> int:
        return sum(len(b) for blobs in self.buckets.values() for b in blobs)


class Warehouse:
    """Hourly-partitioned batch training tables with user bucketing.

    ``n_buckets`` buckets per partition, bucket key = the SAME hash partition
    function used by the immutable UIH store (symmetric sharding): a bucket's
    lookups all route to one storage shard."""

    def __init__(self, schema: ev.TraitSchema, n_buckets: int = 8,
                 cluster_by_user: bool = True):
        self.schema = schema
        self.n_buckets = n_buckets
        self.cluster_by_user = cluster_by_user
        self._partitions: Dict[int, WarehousePartition] = {}
        self.bytes_written = 0
        self.bytes_read = 0

    def ingest(self, examples: Sequence[TrainingExample]) -> None:
        staged: Dict[int, Dict[int, List[TrainingExample]]] = {}
        for exm in examples:
            hour = exm.request_ts // MS_PER_HOUR
            if self.cluster_by_user:
                bucket = shard_of(exm.user_id, self.n_buckets)
            else:
                bucket = exm.request_id % self.n_buckets  # arrival order spray
            staged.setdefault(hour, {}).setdefault(bucket, []).append(exm)
        for hour, buckets in staged.items():
            part = self._partitions.setdefault(
                hour, WarehousePartition(hour=hour, buckets={})
            )
            for bucket, exs in buckets.items():
                if self.cluster_by_user:
                    # cluster a user's temporally-adjacent examples together
                    exs = sorted(exs, key=lambda e: (e.user_id, e.request_ts))
                blobs = [e.to_bytes(self.schema) for e in exs]
                part.buckets.setdefault(bucket, []).extend(blobs)
                self.bytes_written += sum(len(b) for b in blobs)

    def hours(self) -> List[int]:
        return sorted(self._partitions)

    def read_partition(self, hour: int) -> List[TrainingExample]:
        """All examples of one hour; an hour with no data reads as empty (a
        backfill sweep over a contiguous hour range must not trip on gaps)."""
        part = self._partitions.get(hour)
        if part is None:
            return []
        out: List[TrainingExample] = []
        for bucket in sorted(part.buckets):
            for blob in part.buckets[bucket]:
                self.bytes_read += len(blob)
                out.append(TrainingExample.from_bytes(blob, self.schema))
        return out

    def iter_bucketed(self, hour: int) -> Iterator[List[TrainingExample]]:
        """Yield one user-clustered bucket at a time (the batch-training unit of
        work handed to a DPP worker); an empty hour yields nothing."""
        part = self._partitions.get(hour)
        if part is None:
            return
        for bucket in sorted(part.buckets):
            blobs = part.buckets[bucket]
            self.bytes_read += sum(len(b) for b in blobs)
            yield [TrainingExample.from_bytes(b, self.schema) for b in blobs]

    def hour_rows(self, hour: int) -> int:
        """Row count of one hour's partition WITHOUT reading it (no byte
        accounting) — feed checkpoint cursors are metadata-only."""
        part = self._partitions.get(hour)
        if part is None:
            return 0
        return sum(len(blobs) for blobs in part.buckets.values())

    def total_bytes(self) -> int:
        return sum(p.examples_bytes() for p in self._partitions.values())
