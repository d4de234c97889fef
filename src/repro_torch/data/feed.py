"""The uniform ``Feed``: one handle over the compiled read path.

Port of ``repro.data.feed`` (unchanged apart from import paths).

Whatever a ``DatasetSpec`` compiles into — warehouse replay through a
``DPPWorkerPool`` + ``RebatchingClient``, a live ``StreamingSession``, with or
without a ``DevicePrefetcher`` on top — the consumer sees ONE protocol:

  * iterate (or ``get(timeout=...)``) device-/host-ready full batches,
    ``None``/end meaning the feed is exhausted;
  * ``drained`` / ``ended`` — the end-of-stream sentinel was observed (vs a
    ``get`` timeout);
  * ``stats()`` — one composite ``FeedStats`` snapshot (client counters,
    merged worker counters, freshness, co-scan share savings);
  * ``client_stats`` — the live mutable ``ClientStats`` (starvation
    accounting shared with the trainer and elastic controller);
  * ``record_train_step`` / ``recycle`` — trainer backchannel, delegated to
    whichever stage owns it;
  * ``stop()`` — release the device-prefetch stage (queued device batches);
  * ``close()`` — full shutdown: stop prefetching, drain the host pipeline
    untrained so parked workers can exit, join, and re-raise any pipeline
    error;
  * ``join()`` — wait for a fully-consumed pipeline and surface errors.

``Trainer.fit`` consumes a ``Feed`` identically for batch and streaming.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Deque, Dict, Iterator, Optional

from repro_torch.core.materialize import TenantShareStats
from repro_torch.dpp.client import ClientStats
from repro_torch.dpp.worker import WorkerStats
from repro_torch.streaming.session import FreshnessStats


@dataclasses.dataclass
class FeedStats:
    """Composite snapshot of one feed's counters (see DESIGN.md §6/§9).

    Every member is a consistent point-in-time COPY taken by
    ``Feed.snapshot()`` — mutating a ``FeedStats`` never writes through to
    the live pipeline counters."""

    client: ClientStats
    workers: Optional[WorkerStats] = None     # merged across pool workers
    freshness: Optional[FreshnessStats] = None  # streaming feeds only
    share: Optional[TenantShareStats] = None    # co-scan feeds only
    peak_workers: int = 0
    stale_dropped: int = 0               # streaming protocol drops


class _StatsHandle:
    """``feed.stats`` must serve two contracts at once: the legacy feeds
    (``DevicePrefetcher``/``RebatchingClient``/``StreamingSession``) exposed a
    live ``ClientStats`` ATTRIBUTE (``feed.stats.starvation_pct``), while the
    Feed protocol specifies a ``stats()`` METHOD returning a composite
    snapshot. This handle is both: calling it snapshots (``FeedStats``);
    attribute access reads/writes through to the live ``ClientStats`` — so
    call sites migrated off the deprecated ``make_*_feed`` shims keep working
    either way."""

    __slots__ = ("_feed",)

    def __init__(self, feed: "Feed"):
        object.__setattr__(self, "_feed", feed)

    def __call__(self) -> "FeedStats":
        return self._feed.snapshot()

    def __getattr__(self, name):
        return getattr(self._feed.client_stats, name)

    def __setattr__(self, name, value):
        setattr(self._feed.client_stats, name, value)


class Feed:
    """Uniform read-path handle (see module docstring).

    ``inner`` is the stage the consumer pulls from (a ``DevicePrefetcher``,
    ``StreamingSession``, or ``RebatchingClient``); the other stages are held
    for stats, shutdown, and draining. Constructed by ``repro.data.open_feed``
    (or the deprecated ``launch.steps.make_*_feed`` shims).
    """

    def __init__(
        self,
        inner: Any,
        *,
        client: Any = None,
        pool: Any = None,
        session: Any = None,
        prefetcher: Any = None,
        prep_fn=None,
        spec=None,
        share_stats=None,
        resume_meta=None,
        telemetry=None,
        store=None,
    ):
        self._inner = inner
        # per-run repro.obs.Telemetry (None = off): the Feed is the delivery
        # and train end of the span pipeline, and publishes the final
        # composite counters into the metrics registry on close()
        self.telemetry = telemetry
        # the store the feed scans (telemetry publish on close)
        self.store = store
        self.client = client if client is not None else getattr(
            session, "client", None)
        self.pool = pool if pool is not None else getattr(
            session, "pool", None)
        self.session = session
        self.prefetcher = prefetcher
        self.spec = spec
        self.share_stats = share_stats
        # prep applied consumer-side when there is no prefetch stage to run it
        self._prep_fn = prep_fn if prefetcher is None else None
        self._closed = False
        # -- crash-safe checkpoint accounting (§10) ---------------------------
        # ``resume_meta`` is attached by open_feed on checkpointable feeds:
        # {"fingerprint", "base_rows", "base_batches", "hour_rows"?}. The FIFO
        # below maps delivered batches to trained batches: get() pushes each
        # batch's row count, record_train_step() pops the oldest — a batch the
        # prefetcher pulled ahead (or the trainer fetched but never stepped)
        # is therefore NOT counted as trained, which is exactly the set a
        # resume must re-produce.
        self._resume_meta = resume_meta
        self._pending_rows: Deque[int] = collections.deque()
        self._ckpt_lock = threading.Lock()
        self._trained_rows = 0
        self._trained_batches = 0
        self._join_error: list = []
        self._joiner: Optional[threading.Thread] = None
        if pool is not None and session is None:
            # batch pipeline: a background joiner waits out the pool so the
            # client receives its end-of-stream sentinel the moment the work
            # list drains (the consumer must never have to call pool.join()
            # itself — it would deadlock waiting for batches meanwhile)
            def _join() -> None:
                try:
                    pool.join()
                except BaseException as e:  # surfaced by join()/close()
                    self._join_error.append(e)

            self._joiner = threading.Thread(target=_join, daemon=True,
                                            name="feed-joiner")
            self._joiner.start()

    # -- consumption -----------------------------------------------------------
    def get(self, timeout: Optional[float] = None, record: bool = True):
        """Next full batch, or ``None`` (end of stream OR timeout —
        disambiguate via ``drained``). ``record=False`` suppresses the
        starvation accounting (pulls that are not the trainer's critical
        path), propagated to whichever stage owns the counters."""
        g = getattr(self._inner, "get", None)
        if g is not None:                       # DevicePrefetcher stage
            out = g(timeout=timeout, record=record)
        else:
            out = self._inner.get_full_batch(timeout=timeout, record=record)
            if out is not None and self._prep_fn is not None:
                out = self._prep_fn(out)
        if out is not None and record and self.telemetry is not None:
            # pop the span FIFO's delivery side (record=False drains bypass
            # this on purpose — SpanTracker.drain() accounts those batches)
            self.telemetry.spans.mark_delivered()
        if out is not None and record and self._resume_meta is not None:
            # row count from the CLIENT's emission FIFO, not the delivered
            # batch: a prep_fn may reshape batches (e.g. pre-split grad-accum
            # microbatches) and the resume cursor must count source rows
            emitted = getattr(self.client, "emitted_rows", None)
            if emitted:
                rows = emitted.popleft()
            else:
                v = next(iter(out.values()))
                shape = getattr(v, "shape", None)   # numpy OR device arrays
                rows = int(shape[0]) if shape else len(v)
            with self._ckpt_lock:
                self._pending_rows.append(rows)
        return out

    def get_full_batch(self, timeout: Optional[float] = None,
                       record: bool = True):
        """Client-protocol alias (legacy call sites)."""
        return self.get(timeout=timeout, record=record)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while True:
            b = self.get()
            if b is None:
                return
            yield b

    @property
    def ended(self) -> bool:
        return bool(getattr(self._inner, "ended", False))

    @property
    def drained(self) -> bool:
        """True iff the end-of-stream sentinel was observed (the feed is
        exhausted — a ``get`` returning ``None`` alone may just be a
        timeout)."""
        return self.ended

    # -- trainer backchannel ---------------------------------------------------
    def record_train_step(self, seconds: float) -> None:
        if self._resume_meta is not None:
            with self._ckpt_lock:
                if self._pending_rows:   # oldest delivered batch now trained
                    self._trained_rows += self._pending_rows.popleft()
                    self._trained_batches += 1
                trained = self._trained_rows
            if self.session is not None:
                # steady-state bound on the session's resume ledger even when
                # the trainer never checkpoints
                self.session.trim_ledger(trained)
        rec = getattr(self._inner, "record_train_step", None)
        if rec is not None:
            rec(seconds)
        if self.telemetry is not None:
            self.telemetry.spans.record_train(seconds)

    def recycle(self, batch) -> None:
        rec = getattr(self._inner, "recycle", None)
        if rec is not None:
            rec(batch)

    # -- stats -----------------------------------------------------------------
    @property
    def client_stats(self) -> Optional[ClientStats]:
        """The live mutable ClientStats (starvation/train-time accounting)."""
        if self.client is not None:
            return self.client.stats
        return getattr(self._inner, "stats", None)

    @property
    def stats(self) -> _StatsHandle:
        """Dual-contract handle: ``feed.stats()`` -> composite ``FeedStats``
        snapshot (the Feed protocol); ``feed.stats.<counter>`` -> the live
        ``ClientStats`` field (the legacy feed-object contract)."""
        return _StatsHandle(self)

    def snapshot(self) -> FeedStats:
        """Point-in-time snapshot: every member is a COPY, so the repo's
        before/after delta idiom works (the live mutable counters stay
        reachable via ``client_stats``)."""

        def copy(obj):
            return dataclasses.replace(obj) if obj is not None else None

        workers = None
        if self.pool is not None:
            workers = self.pool.merged_worker_stats()  # already a fresh merge
        return FeedStats(
            client=copy(self.client_stats) or ClientStats(),
            workers=workers,
            freshness=copy(getattr(self.session, "freshness", None)),
            share=copy(self.share_stats),
            peak_workers=getattr(self.pool, "peak_workers", 0),
            stale_dropped=getattr(self.session, "stale_dropped", 0),
        )

    def publish_telemetry(self) -> None:
        """Flush the composite counters into the telemetry registry and close
        out spans still riding the FIFOs. Idempotent (the registry adapters
        take monotone maxima); called by ``close()``, callable any time for a
        mid-run flush."""
        tel = self.telemetry
        if tel is None:
            return
        snap = self.snapshot()
        tel.publish_stats(snap.client, "client")
        if snap.workers is not None:
            tel.publish_stats(snap.workers, "worker")
        if snap.freshness is not None:
            tel.publish_stats(snap.freshness, "freshness")
        if snap.share is not None:
            tel.publish_stats(snap.share, "share")
        tel.registry.gauge(
            "repro_feed_peak_workers",
            help="peak concurrent DPP workers").set(snap.peak_workers)
        tel.registry.counter(
            "repro_feed_stale_dropped_total",
            help="streaming protocol drops").set_total(snap.stale_dropped)
        if self.session is not None:
            src = getattr(self.session, "source", None)
            if src is not None:
                tel.publish_stats(src.stats, "source")
            coord = getattr(self.session, "coordinator", None)
            if coord is not None:
                tel.publish_stats(coord.stats, "backfill",
                                  gauge_fields=("watermark",))
        pub = getattr(self.store, "publish_telemetry", None)
        if pub is not None:
            pub()

    # -- crash-safe checkpoint (§10) --------------------------------------------
    @property
    def can_checkpoint(self) -> bool:
        """True iff this feed was compiled by ``open_feed`` with resumable
        plumbing (ordered placement; for streaming, the warehouse backfill
        leg). Shim-constructed feeds cannot checkpoint."""
        return self._resume_meta is not None

    def checkpoint(self) -> Dict[str, Any]:
        """Minimal cursor state for exactly-once resume (§10): pass the dict
        to ``open_feed(spec, sim, resume_from=...)`` after a restart (the
        ``CheckpointManager`` saves it as a ``feed_state`` sidecar atomically
        with the model state).

        Counts only rows whose gradient was APPLIED (``record_train_step``
        consumed them) — batches pulled ahead by a prefetcher, or delivered
        but killed before the step, are re-produced by the resumed feed.
        Call from the training thread (the same serialization point the
        model checkpoint is taken at)."""
        if self._resume_meta is None:
            raise ValueError(
                "checkpoint() requires a spec-compiled, ordered feed "
                "(repro.data.open_feed); shim feeds cannot checkpoint")
        meta = self._resume_meta
        with self._ckpt_lock:
            local_rows = self._trained_rows
            local_batches = self._trained_batches
        state: Dict[str, Any] = {
            "kind": "stream" if self.session is not None else "batch",
            "fingerprint": meta["fingerprint"],
            "trained_rows": meta["base_rows"] + local_rows,
            "trained_batches": meta["base_batches"] + local_batches,
        }
        if self.session is not None:
            state["stream"] = self.session.checkpoint_state(local_rows)
        else:
            hour_rows = meta.get("hour_rows")
            if hour_rows:
                state["warehouse"] = self._warehouse_cursor(
                    hour_rows, state["trained_rows"])
        return state

    @staticmethod
    def _warehouse_cursor(hour_rows, trained_rows: int) -> Dict[str, int]:
        """Observability view of a batch cursor: (hour, intra-hour offset) of
        the next untrained example in the warehouse replay order."""
        remaining = trained_rows
        for hour, n in hour_rows:
            if remaining < n:
                return {"hour": int(hour), "offset": int(remaining)}
            remaining -= n
        last = hour_rows[-1]
        return {"hour": int(last[0]), "offset": int(last[1])}  # exhausted

    # -- lifecycle -------------------------------------------------------------
    def stop(self) -> None:
        """Release the device-prefetch stage (queued device buffers). The host
        pipeline keeps running — use ``close()`` for full shutdown."""
        if self.prefetcher is not None:
            self.prefetcher.stop()

    def join(self) -> None:
        """Wait for a fully-consumed pipeline to finish and re-raise any
        worker/feeder error. Call only after consuming the whole feed — use
        ``close()`` if the consumer walked away early."""
        if self.session is not None:
            self.session.join()
        if self._joiner is not None:
            self._joiner.join()
        if self._join_error:
            raise self._join_error[0]

    def close(self, timeout: Optional[float] = None) -> None:
        """Full shutdown (idempotent): stop the prefetch stage, drain the host
        pipeline untrained so workers parked on the bounded slot queue can
        exit, then join and surface any pipeline error. ``timeout`` bounds the
        drain; on expiry the daemon threads are abandoned. A shim feed over a
        bare client (caller-owned pool) drains in the background instead —
        close() returns immediately and the caller's own ``pool.join()``
        both finishes the drain and terminates it."""
        if self._closed:
            return
        self._closed = True
        try:
            self._close_inner(timeout)
        finally:
            if self.telemetry is not None:
                # close out spans still riding the FIFOs, then flush the
                # final composite counters — even when join() re-raises a
                # pipeline error (chaos runs must still report)
                self.telemetry.spans.drain()
                self.publish_telemetry()

    def _close_inner(self, timeout: Optional[float]) -> None:
        self.stop()
        if self.session is not None:
            self.session.close(timeout=timeout)
            return
        if self.client is not None and self._joiner is None:
            # Shim-constructed feed around a BARE client (the deprecated
            # make_*_feed path): the pool — and thus the pool.join() that
            # sends the client's end-of-stream sentinel — belongs to the
            # CALLER and runs only after this close() returns. Drain in the
            # background so workers parked on the bounded slot queues are
            # released while the caller joins its own pool; the sentinel that
            # join sends is what stops the drainer. Daemon: if the caller
            # never joins, it idles until process exit.
            client = self.client

            def _drain() -> None:
                while not getattr(client, "ended", True):
                    b = client.get_full_batch(timeout=0.05, record=False)
                    if b is not None:
                        client.recycle(b)

            threading.Thread(target=_drain, daemon=True,
                             name="feed-shim-drainer").start()
            self.join()
            return
        if self._joiner is not None and self.client is not None:
            deadline = (None if timeout is None
                        else time.perf_counter() + timeout)
            while self._joiner.is_alive():
                if deadline is not None and time.perf_counter() > deadline:
                    # drain timed out: abandon the daemon threads, but still
                    # surface any pipeline error already captured — a close()
                    # that swallows a worker failure would report success on
                    # silently truncated training data
                    if self._join_error:
                        raise self._join_error[0]
                    return
                b = self.client.get_full_batch(timeout=0.05, record=False)
                if b is not None:
                    self.client.recycle(b)
        self.join()

    def __enter__(self) -> "Feed":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
