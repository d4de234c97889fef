"""Streaming probe side (paper §3.2): stream -> deadline/size-bounded
micro-batches.

``StreamingSource`` drains a ``TrainingExampleStream`` into micro-batches that
flush on whichever bound trips first:

  * **size** — ``max_examples`` reached (throughput mode under backlog);
  * **deadline** — ``max_delay_s`` elapsed since the batch's first example
    (freshness mode under trickle traffic: a lone example never waits longer
    than the deadline for company);
  * **drain** — the stream is closed and empty (``TrainingExampleStream.drained``
    disambiguates this from a consume timeout), flushing the remainder.

The emitted micro-batches are the work items the ``DPPWorkerPool`` feeds to
``DPPWorker.process_jagged`` — the streaming trainer reuses the batch data
plane unchanged. The source also tracks the freshness signals the session
aggregates: per-example publish→drain latency and the stream backlog (lag).

``ack()`` releases the examples' generation leases once they have been
materialized — the "drained" transition that lets the store GC superseded
generations.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional

from repro_torch.core.versioning import TrainingExample
from repro_torch.storage.stream import StreamDisconnect, TrainingExampleStream


@dataclasses.dataclass
class MicroBatchConfig:
    max_examples: int = 32     # size bound (flush when reached)
    max_delay_s: float = 0.05  # deadline bound from the batch's FIRST example
    poll_s: float = 0.02       # consume-wait granularity (drain/deadline checks)


@dataclasses.dataclass
class SourceStats:
    examples: int = 0
    micro_batches: int = 0
    size_flushes: int = 0
    deadline_flushes: int = 0
    drain_flushes: int = 0
    reconnects: int = 0               # transient StreamDisconnects healed
    publish_to_drain_s: float = 0.0   # summed over latency_samples
    latency_samples: int = 0
    max_lag: int = 0                  # peak stream backlog observed

    @property
    def mean_publish_to_drain_s(self) -> float:
        if not self.latency_samples:
            return 0.0
        return self.publish_to_drain_s / self.latency_samples


class StreamingSource:
    def __init__(self, stream: TrainingExampleStream,
                 cfg: Optional[MicroBatchConfig] = None):
        self.stream = stream
        self.cfg = cfg or MicroBatchConfig()
        self.stats = SourceStats()
        # optional repro_torch.obs.Telemetry (control-plane events)
        self.telemetry = None
        # attach: examples published from here on get freshness clocks (the
        # pre-attach backlog is catch-up traffic — latency samples would only
        # measure how old the backlog is, not the live loop)
        stream.track_freshness = True
        # publish wall clocks held until the session settles event->gradient
        self._pub_wall: Dict[int, float] = {}

    # -- micro-batching ---------------------------------------------------------
    def micro_batches(self) -> Iterator[List[TrainingExample]]:
        cfg = self.cfg
        buf: List[TrainingExample] = []
        deadline = 0.0
        while True:
            if buf:
                timeout = min(cfg.poll_s,
                              max(0.0, deadline - time.perf_counter()))
            else:
                timeout = cfg.poll_s
            try:
                exm = self.stream.consume(timeout=timeout)
            except StreamDisconnect:
                # transient broker failure: the stream retains unacked
                # messages, so reconnect-and-repoll loses nothing (and the
                # buffered micro-batch keeps its deadline)
                self.stats.reconnects += 1
                if self.telemetry is not None:
                    self.telemetry.events.emit(
                        "stream_reconnect", reconnects=self.stats.reconnects)
                continue
            now = time.perf_counter()
            if exm is not None:
                if not buf:
                    deadline = now + cfg.max_delay_s
                buf.append(exm)
                pw = self.stream.publish_wall(exm.request_id)
                if pw is not None:
                    self._pub_wall[exm.request_id] = pw
                    self.stats.publish_to_drain_s += now - pw
                    self.stats.latency_samples += 1
                lag = self.stream.lag()
                if lag > self.stats.max_lag:
                    self.stats.max_lag = lag
                if len(buf) >= cfg.max_examples:
                    self.stats.size_flushes += 1
                    yield self._emit(buf)
                    buf = []
                elif now >= deadline:
                    # a steady trickle keeps consume() succeeding — the
                    # deadline must flush here too, not only on a timeout
                    self.stats.deadline_flushes += 1
                    yield self._emit(buf)
                    buf = []
                continue
            # consume returned None: end of stream, deadline, or plain timeout
            if self.stream.drained:
                if buf:
                    self.stats.drain_flushes += 1
                    yield self._emit(buf)
                return
            if buf and now >= deadline:
                self.stats.deadline_flushes += 1
                yield self._emit(buf)
                buf = []

    def _emit(self, buf: List[TrainingExample]) -> List[TrainingExample]:
        self.stats.examples += len(buf)
        self.stats.micro_batches += 1
        return list(buf)

    # -- lease + freshness bookkeeping ------------------------------------------
    def ack(self, examples) -> None:
        """Release generation leases of materialized examples (drained), and
        drop any publish clocks nobody harvested — a session pops them first
        via ``pop_pub_wall``; a session-less consumer (e.g. a streaming
        audit) must not accrete them forever."""
        for exm in examples:
            self.stream.ack(exm)
            self._pub_wall.pop(getattr(exm, "request_id", exm), None)

    def pop_pub_wall(self, request_id: int) -> Optional[float]:
        return self._pub_wall.pop(request_id, None)

    def discard(self, example) -> None:
        """Forget a skipped example entirely (lease + freshness clock) — the
        backfill coordinator's duplicate filter uses this."""
        self.ack([example])
