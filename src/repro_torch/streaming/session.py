"""Streaming training session (paper §3.2): event → gradient, one object.

``StreamingSession`` closes the loop the batch pipeline leaves open: a
``StreamingSource`` (optionally fronted by a ``BackfillCoordinator`` for the
batch→stream catch-up handoff) feeds micro-batches into the existing
``DPPWorkerPool`` → ``RebatchingClient`` data plane, and the session itself
speaks the client's feed protocol (``get_full_batch`` / ``recycle`` /
``record_train_step`` / ``stats``) so a ``Trainer`` or ``DevicePrefetcher``
consumes it exactly like a batch feed.

Protocol duties handled here:

  * **lease release**: after a worker materializes+featurizes a micro-batch,
    its examples' generation leases are released (``TrainingExampleStream.ack``)
    — the store may then GC superseded generations ("GC once drained");
  * **freshness**: each example's publish wall clock rides from the stream
    through the source into a FIFO settlement queue; each
    ``record_train_step`` call (the trainer's step-completion signal, which a
    ``DevicePrefetcher`` delegates through) settles the OLDEST delivered
    batch's rows into event→gradient latency samples — correct even when the
    prefetcher pulls ``depth`` batches ahead of the gradient (FIFO
    row-matching is exact at full-batch granularity, approximate at row
    granularity under the reshuffle — documented, and irrelevant to the
    mean). A consumer that never records steps still gets all samples
    settled, late, at ``join()``.

  * **leases across the flip**: a stream copy of an example whose warehouse
    copy is still being materialized keeps its lease (leases are keyed by
    ``request_id``) until that copy's work item is done. Released at once,
    as ``repro.streaming.session`` releases it, the store may GC the logged
    generation under the replay; the replayed window then re-resolves
    against a newer generation, and where compaction's lookback has moved
    since, its checksum fails and the example is dropped untrained.

Shutdown: close the stream; the source drains, the feeder finishes, workers
exit, the pool closes the client, the trainer sees end-of-stream. ``join()``
then surfaces any worker/feeder error.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.core.materialize import ChecksumMismatch
from repro_torch.dpp.client import RebatchingClient
from repro_torch.dpp.elastic import DPPWorkerPool, ElasticController
from repro_torch.dpp.worker import DPPWorker, WorkerPlan
from repro_torch.storage.stream import TrainingExampleStream, Warehouse
from repro_torch.streaming.backfill import BackfillCoordinator, ReplayFilter
from repro_torch.streaming.source import MicroBatchConfig, StreamingSource


@dataclasses.dataclass
class FreshnessStats:
    batches_delivered: int = 0
    rows_settled: int = 0
    samples: int = 0
    event_to_gradient_s_sum: float = 0.0
    event_to_gradient_s_max: float = 0.0

    @property
    def mean_event_to_gradient_s(self) -> float:
        if not self.samples:
            return 0.0
        return self.event_to_gradient_s_sum / self.samples


class _AckingWorker:
    """Wraps a ``DPPWorker``: after a micro-batch is materialized+featurized,
    release its generation leases and queue its publish clocks for freshness
    settlement. Duck-compatible with ``DPPWorkerPool`` (stats/process*).

    A ``ChecksumMismatch``/``StaleGeneration`` from the materializer is the
    protocol's *drop this example* signal (its window genuinely changed, e.g.
    right-to-delete): the worker triages the micro-batch per example, drops
    the offenders (counted in ``session.stale_dropped``, leases released),
    and featurizes the survivors — it must NOT die and take the session down.
    """

    def __init__(self, inner, session: "StreamingSession"):
        self._inner = inner
        self._session = session

    @property
    def stats(self):
        return self._inner.stats

    @property
    def materializer(self):
        return self._inner.materializer

    def process(self, examples):
        return self._process(examples, self._inner.process)

    def process_jagged(self, examples):
        return self._process(examples, self._inner.process_jagged)

    def _process(self, examples, fn):
        kept = list(examples)
        dropped_all: List = []
        while True:
            try:
                out = fn(kept) if kept else None
                break
            except ChecksumMismatch:
                kept, dropped = self._triage(kept)
                dropped_all.extend(dropped)
                if not dropped:
                    # fn raised but per-example triage passed everything: a
                    # flip landed between triage and the batch re-run. Drop
                    # the remainder rather than loop (or die) — rare double
                    # race, and dropping is always protocol-safe.
                    dropped_all.extend(kept)
                    kept = []
        self._session._on_item_done(kept, dropped=dropped_all, item=examples)
        return out

    def _triage(self, examples):
        keep, dropped = [], []
        mat, projection = self._inner.materializer, self._inner.projection
        for exm in examples:
            try:
                mat.materialize(exm, projection)
                keep.append(exm)
            except ChecksumMismatch:
                dropped.append(exm)
        return keep, dropped


class StreamingSession:
    def __init__(
        self,
        stream: TrainingExampleStream,
        make_worker,
        *,
        full_batch_size: int,
        micro_batch: Optional[MicroBatchConfig] = None,
        n_workers: int = 2,
        controller: Optional[ElasticController] = None,
        shuffle_seed: Optional[int] = 0,
        buffer_batches: int = 4,
        backfill_from: Optional[Warehouse] = None,
        jagged: bool = True,
        ordered: bool = False,
        max_item_retries: int = 0,
        retry_backoff=None,
        emit_seq_start: int = 0,
        resume_filters: Optional[List[ReplayFilter]] = None,
        backfill_start_hour: Optional[int] = None,
        backfill_end_hour: Optional[int] = None,
    ):
        self.source = StreamingSource(stream, micro_batch)
        mb = self.source.cfg.max_examples
        self.coordinator = (
            BackfillCoordinator(backfill_from, self.source, micro_batch=mb,
                                start_hour=backfill_start_hour,
                                end_hour=backfill_end_hour,
                                resume_filters=resume_filters or (),
                                on_duplicate=self._on_duplicate)
            if backfill_from is not None else None
        )
        # replayed request ids whose work item is not done yet, and the live
        # copies of them held back meanwhile (see "leases across the flip")
        self._replay_inflight: set = set()
        self._held_copies: Dict[int, object] = {}
        self._flip_lock = threading.Lock()
        self.client = RebatchingClient(full_batch_size,
                                       buffer_batches=buffer_batches,
                                       shuffle_seed=shuffle_seed,
                                       emit_seq_start=emit_seq_start)
        self.freshness = FreshnessStats()
        self._pub_q: Deque[float] = collections.deque()
        self._pq_lock = threading.Lock()
        self._delivered: Deque[int] = collections.deque()  # rows per pulled batch
        self._n_workers = n_workers
        if isinstance(make_worker, WorkerPlan):
            # a spec-compiled plan (declarative read path): build the
            # per-thread worker factory from it
            plan = make_worker
            make_worker = lambda: DPPWorker.from_plan(plan)  # noqa: E731
        self.ordered = ordered
        self._resume_filters = list(resume_filters or [])
        # placement-order ledger (ordered mode): per PLACED row, its
        # ``(request_id, coord_pos, is_replay)`` — ``coord_pos`` is the count
        # of COORDINATOR-emitted rows consumed up to and including this row
        # (triage-dropped and abandoned rows count as consumed: protocol drops
        # stay dropped across a resume). Feed.checkpoint maps "rows trained"
        # to the replay-prefix cursor / live watermark through it; trimmed
        # lazily at checkpoint time.
        self._ledger: Deque[tuple] = collections.deque()
        self._ledger_base = 0          # placement position of _ledger[0]
        self._coord_consumed = 0       # coordinator rows placed or skipped
        self._ledger_lock = threading.Lock()
        # worker-completion-time survivor indices, keyed by work-item id:
        # _AckingWorker may drop stale examples, and the ledger must record
        # exactly the rows that were PLACED at their in-item offsets (the
        # pool's on_place hands back the original item, which stays
        # referenced until placement)
        self._kept_by_item: Dict[int, List[tuple]] = {}
        self.abandoned = 0             # examples dropped by crash recovery
        # resume bookkeeping only when a checkpoint is actually producible
        # (ordered + a durable warehouse leg) — a live-only ordered session
        # must not accrete a ledger nothing ever trims
        track = ordered and self.coordinator is not None
        self.pool = DPPWorkerPool(
            lambda: _AckingWorker(make_worker(), self),
            self.client, n_workers=n_workers, controller=controller,
            jagged=jagged, ordered=ordered, max_item_retries=max_item_retries,
            retry_backoff=retry_backoff,
            on_place=self._on_place if track else None,
            on_abandon=self._on_abandon if max_item_retries > 0 else None,
            on_skip=self._on_skip if track else None,
        )
        self._started = False
        self._joiner: Optional[threading.Thread] = None
        self._join_error: List[BaseException] = []
        # examples dropped by stale-generation triage (window truly changed)
        self.stale_dropped = 0

    # -- telemetry ---------------------------------------------------------------
    @property
    def telemetry(self):
        return self.client.telemetry

    @telemetry.setter
    def telemetry(self, tel) -> None:
        """Attach a ``repro_torch.obs.Telemetry`` to every stage the session owns
        (client emit spans, pool item spans + worker events, source
        reconnects, backfill flip). Set BEFORE ``start()``."""
        self.client.telemetry = tel
        self.pool.telemetry = tel
        self.source.telemetry = tel
        if self.coordinator is not None:
            self.coordinator.telemetry = tel

    # -- lifecycle --------------------------------------------------------------
    def start(self) -> "StreamingSession":
        """Start draining. A background joiner waits out the pool so the
        client receives its end-of-stream sentinel the moment the stream
        drains — the consumer must never be the one who has to call
        ``pool.join()`` (it would deadlock waiting for batches meanwhile)."""
        if not self._started:
            self._started = True
            if self.coordinator is not None:
                batches = self._track_replay(self.coordinator.micro_batches())
            else:
                batches = self.source.micro_batches()
            # bound the in-flight micro-batches: backpressure keeps a fast
            # backfill replay from materializing the whole warehouse at once
            self.pool.start_stream(batches,
                                   max_buffered=4 * self._n_workers + 8)

            def joiner() -> None:
                try:
                    self.pool.join()   # closes the client even on failure
                except BaseException as e:
                    self._join_error.append(e)

            self._joiner = threading.Thread(target=joiner, daemon=True,
                                            name="streaming-joiner")
            self._joiner.start()
        return self

    def join(self) -> None:
        """Wait for the drain (stream closed + queue empty) and re-raise any
        worker/feeder failure. Call only after consuming the whole stream —
        a consumer that walked away early must use ``stop()`` instead (the
        workers are blocked on the bounded client queue and need a drainer)."""
        self._settle_all()
        if self._joiner is not None:
            self._joiner.join()
        self._release_held(list(self._held_copies))   # items that never ended
        if self._join_error:
            raise self._join_error[0]

    def stop(self, timeout: Optional[float] = None) -> None:
        """Abandon training mid-stream: keep draining (and recycling) full
        batches WITHOUT training until the pipeline shuts down, then join.
        This unblocks workers parked on the bounded client queue after the
        trainer exits early (``max_wall_s`` / ``max_steps``). Termination
        still requires the producer to close the stream; ``timeout`` bounds
        the wait (on expiry the daemon threads are simply abandoned)."""
        if not self._started or self._joiner is None:
            return
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while self._joiner.is_alive():
            if deadline is not None and time.perf_counter() > deadline:
                return
            b = self.client.get_full_batch(timeout=0.05, record=False)
            if b is not None:
                self.client.recycle(b)
        self.join()

    # -- leases across the flip -------------------------------------------------
    def _track_replay(self, batches):
        """Pass the coordinator's micro-batches on, noting each replayed
        (pre-flip) one's ids as in flight until its work item is done."""
        for mb in batches:
            if not self.coordinator.stats.flipped:
                with self._flip_lock:
                    self._replay_inflight.update(e.request_id for e in mb)
            yield mb

    def _on_duplicate(self, exm) -> None:
        """A live copy of a replayed example: forget it now, or once its
        warehouse copy's item is done when that is still in flight."""
        with self._flip_lock:
            if exm.request_id in self._replay_inflight:
                self._held_copies[exm.request_id] = exm
                return
        self.source.discard(exm)

    def _release_held(self, request_ids) -> None:
        """The items of these replayed ids are done: drop them from the
        in-flight set and forget the live copies held back for them."""
        with self._flip_lock:
            self._replay_inflight.difference_update(request_ids)
            held = [self._held_copies.pop(r) for r in request_ids
                    if r in self._held_copies]
        for exm in held:
            self.source.discard(exm)

    # -- worker-side callbacks ---------------------------------------------------
    def _on_item_done(self, examples, dropped=(), item=None) -> None:
        walls: List[float] = []
        for exm in examples:
            w = self.source.pop_pub_wall(exm.request_id)
            if w is not None:
                walls.append(w)
        if walls:
            with self._pq_lock:
                self._pub_q.extend(walls)
        self.source.ack(examples)
        if item is not None and self.ordered and self.coordinator is not None:
            # remember which rows survived triage AND their in-item offsets:
            # placement happens later (in item order) and the resume cursor
            # must count triage-dropped rows as consumed coordinator rows
            kept_ids = {e.request_id for e in examples}
            self._kept_by_item[id(item)] = [
                (e.request_id, idx) for idx, e in enumerate(item)
                if e.request_id in kept_ids]
        if dropped:
            # stale-drop path: release leases + clocks, but contribute no
            # freshness samples (these rows never reach a gradient)
            self.stale_dropped += len(dropped)
            self.source.ack(dropped)
        if item is not None and self._replay_inflight:
            self._release_held([e.request_id for e in item])

    def _on_place(self, item) -> None:
        """Pool placer callback (ordered mode): rows of ``item`` just entered
        the client, in work-item sequence order."""
        kept = self._kept_by_item.pop(id(item), None)
        if kept is None:
            kept = [(e.request_id, idx) for idx, e in enumerate(item)]
        st = self.coordinator.stats if self.coordinator is not None else None
        with self._ledger_lock:
            base = self._coord_consumed
            # a replay item's rows were counted in warehouse_examples BEFORE
            # emission (and all replay rows are emitted, hence placed, before
            # any live row), so this classification cannot race wrong
            replay = st is not None and base < st.warehouse_examples
            self._ledger.extend((rid, base + idx + 1, replay)
                                for rid, idx in kept)
            self._coord_consumed = base + len(item)

    def _trim_ledger_locked(self, trained_rows: int) -> None:
        """Drop ledger entries before the LAST trained row (never needed
        again). Call with ``_ledger_lock`` held."""
        while self._ledger_base < trained_rows - 1 and self._ledger:
            self._ledger.popleft()
            self._ledger_base += 1

    def trim_ledger(self, trained_rows: int) -> None:
        """Steady-state ledger bound: the owning Feed calls this per trained
        batch, so ledger size tracks the in-flight window even when the
        trainer never checkpoints (no ckpt_dir)."""
        with self._ledger_lock:
            self._trim_ledger_locked(trained_rows)

    def _on_skip(self, item) -> None:
        """Pool placer callback for an ABANDONED item reaching its placement
        turn: its rows consumed coordinator positions without being placed
        (dropped by protocol — a resume must not shift later rows' cursor)."""
        with self._ledger_lock:
            self._coord_consumed += len(item)

    def _on_abandon(self, item, exc) -> None:
        """Pool crash-recovery callback: an item exhausted its retries. Drop
        its examples (protocol-safe, like a stale drop) and release their
        generation leases so a crashed worker can never leak a pinned
        generation."""
        self._kept_by_item.pop(id(item), None)
        self.source.ack(item)
        self._release_held([e.request_id for e in item])
        self.abandoned += len(item)
        self.pool.record_lease_recoveries(len(item))

    # -- feed protocol (Trainer / DevicePrefetcher face) --------------------------
    @property
    def stats(self):
        return self.client.stats

    @property
    def ended(self) -> bool:
        return self.client.ended

    @property
    def drained(self) -> bool:
        """Feed-protocol drain signal: the end-of-stream sentinel reached the
        consumer (stream closed, every batch delivered)."""
        return self.client.ended

    def close(self, timeout: Optional[float] = None) -> None:
        """Feed-protocol shutdown: drain the remaining stream untrained and
        join (see ``stop``)."""
        self.stop(timeout=timeout)

    def get_full_batch(self, timeout: Optional[float] = None,
                       record: bool = True):
        self.start()
        out = self.client.get_full_batch(timeout=timeout, record=record)
        if out is not None:
            self.freshness.batches_delivered += 1
            with self._pq_lock:
                self._delivered.append(len(next(iter(out.values()))))
        return out

    def _settle_one(self) -> None:
        """Convert the oldest delivered batch's publish clocks into
        event→gradient samples (FIFO at full-batch granularity)."""
        now = time.perf_counter()
        fr = self.freshness
        with self._pq_lock:
            if not self._delivered:
                return
            rows = self._delivered.popleft()
            take = min(rows, len(self._pub_q))
            for _ in range(take):
                dt = now - self._pub_q.popleft()
                fr.event_to_gradient_s_sum += dt
                if dt > fr.event_to_gradient_s_max:
                    fr.event_to_gradient_s_max = dt
                fr.samples += 1
            fr.rows_settled += rows

    def _settle_all(self) -> None:
        while self._delivered:
            self._settle_one()

    def recycle(self, batch: Dict[str, np.ndarray]) -> None:
        self.client.recycle(batch)

    def record_train_step(self, seconds: float) -> None:
        # the trainer (directly, or via DevicePrefetcher delegation) just
        # finished a step: the oldest delivered batch's gradient is applied
        self._settle_one()
        self.client.record_train_step(seconds)

    def __iter__(self):
        while True:
            b = self.get_full_batch()
            if b is None:
                return
            yield b

    # -- crash-safe resume -------------------------------------------------------
    def checkpoint_state(self, trained_rows: int) -> Dict:
        """Minimal cursor for exactly-once resume after ``trained_rows`` rows
        reached a gradient (``Feed.checkpoint`` supplies the count from its
        delivered/trained FIFO).

        Requires ``ordered`` placement and a backfill coordinator: the
        warehouse leg of the bifurcated pipeline is the durable replay source,
        and in-order placement makes "rows trained" identify an exact prefix
        of (replay order ++ live id order). The returned filter chain is this
        session's inherited filters plus one new ``ReplayFilter``:

        * ``skip_rows`` — COORDINATOR replay rows covered by training: the
          coord position of the last trained replay row, counting any
          triage-dropped / abandoned rows interleaved before it (protocol
          drops stay dropped across a resume, so they are "covered" too);
          once a live row has trained, every emitted replay row is covered
          and ``skip_rows`` is the coordinator's full pre-triage count;
        * ``(drop_lo, drop_hi]`` — the live-trained request-id interval:
          ``drop_lo`` is the flip watermark (every kept live id exceeds it),
          ``drop_hi`` the id of the last trained row, read from the
          placement-order ledger. Live ids arrive monotonically (request_ids
          are allocated in arrival order), so the interval is exact."""
        if not self.ordered:
            raise ValueError(
                "streaming checkpoint requires ordered placement "
                "(StreamingSession(ordered=True) / DatasetSpec.ordered)")
        if self.coordinator is None:
            raise ValueError(
                "streaming checkpoint requires the warehouse backfill leg "
                "(StreamSource(backfill=True)) — the stream alone is not a "
                "durable replay source")
        st = self.coordinator.stats
        skip = 0
        lo = hi = -1
        if trained_rows > 0:
            with self._ledger_lock:
                self._trim_ledger_locked(trained_rows)
                idx = trained_rows - 1 - self._ledger_base
                if idx < 0 or idx >= len(self._ledger):
                    raise RuntimeError(
                        f"placement ledger out of sync: trained_rows="
                        f"{trained_rows}, base={self._ledger_base}, "
                        f"len={len(self._ledger)}")
                last_id, coord_pos, is_replay = self._ledger[idx]
            if is_replay:
                skip = coord_pos
            else:                    # live rows reached a gradient
                skip = st.warehouse_examples   # final: flip preceded any live
                lo = st.watermark
                hi = last_id
        new = ReplayFilter(skip_rows=skip, drop_lo=lo, drop_hi=hi)
        return {
            "filters": [f.to_state() for f in self._resume_filters]
                       + [new.to_state()],
            "replay_range": [self.coordinator.start_hour,
                             self.coordinator.end_hour],
            "watermark": st.watermark,
        }

    # -- introspection -----------------------------------------------------------
    def merged_worker_stats(self):
        return self.pool.merged_worker_stats()

    @property
    def backfill_stats(self):
        return self.coordinator.stats if self.coordinator is not None else None
