"""Per-batch pipeline spans: correlation ids riding the work-item ledger
(DESIGN.md §13).

A span is minted when a work item is sequenced into the DPP pool
(``DPPWorkerPool._task`` — the moment the scan plan's micro-batch enters the
pipeline); its correlation id IS the pool's work-item ``seq``, the same id
the placement ledger and retry machinery already carry, so spans survive
worker crashes, requeues and failovers for free.  Stage timestamps are
recorded ambiently: the pool parks the item's span in a thread-local around
``worker.process*`` and the placement ``put``, and the worker/client record
stages via :func:`current_span` without knowing telemetry exists (one
thread-local read when telemetry is off).

Stages (float seconds on ``obs.clock``'s epoch base, ``now_ns() / 1e9``, the
base of a ``torch.profiler`` trace; a retried attempt OVERWRITES the stage so
the surviving chain is the attempt that actually produced data):

    scan       store lookup incl. decode (decode runs on store-internal
               shard threads, so it folds into scan; the scan stage carries
               IOStats-delta metadata — bytes_scanned/bytes_decoded — so
               decode weight stays visible)
    featurize  jagged featurization on the DPP worker
    place      rebatch placement (ordered placer / worker delivery)
    h2d        host-to-device transfer (present when a DevicePrefetcher runs)
    train      device step wall time (present when a Trainer drives the feed)

plus two point timestamps on the batch: ``t_emit`` (slot commit) and
``t_deliver`` (handed to the consumer).

Batch association: every committed slot carries the item spans that wrote
rows into it; at commit the tracker appends a ``BatchSpan`` to an emission
FIFO that rides parallel to the client's output queue.  The prefetcher pops
that FIFO to attach the h2d stage; ``Feed.get`` pops the delivery side; and
``record_train_step`` closes the chain.  Unsampled batches flow through the
FIFOs as lightweight placeholders so the queues never desynchronize.
Association is exact in ordered mode (a single placer thread owns
commit order); in unordered mode it is best-effort FIFO matching.

Sampling: 1-in-``sample_every`` items get a span (seq modulo). ``sample_every=1``
records everything (tests).

Thread phases. Beside the sampled item spans the tracker keeps a bounded
ring of phase spans (``PHASE_CAPACITY``), unsampled: ``(name, thread,
t0_ns, t1_ns, cpu_ns, id)`` on ``obs.clock``'s nanoseconds, ``cpu_ns`` the
growth of ``time.thread_time_ns()`` over the span, with a ``dropped`` count
once the ring is full. A thread records consecutive phases through a
``PhaseClock``: the trainer ``train.feed_wait``, ``train.grads``,
``train.optimizer`` and ``train.readback`` under the step number; the
transfer thread ``h2d.pull``, then ``h2d.stage`` and ``h2d.launch`` once an
array (and ``h2d.launch`` once a densify kernel), ``h2d.event_wait`` and
``h2d.offer`` under the batch's ``emit_seq``; each
DPP worker ``dpp.scan`` and ``dpp.featurize`` (and ``dpp.place``) under the
work item's seq. On CUDA a phase also carries the device milliseconds
between CUDA events recorded inside it (``device_ms``: ``grads``,
``optimizer`` and ``readback`` on the trainer's stream; ``copy`` and
``densify`` on the transfer thread's side stream), resolved lazily by
``resolve()`` (``query()``, never a synchronize on the hot path) at each
``commit`` that filed marks, and in full by ``timeline()`` and ``drain()``.
``obs.timeline`` reads the ring back: a summary by thread and phase, and
the overlap of phases with a trace's device intervals.

Cost: with telemetry off every site is one ``is None`` test and no CPU
clock is read. With it on (every phase, unsampled, and the CUDA events),
the benchmark's two cells on one H100 80GB HBM3 (700 W) trained at 127.1
against 127.5 examples/s (DLRM-UIH, L=2048) and 29,847 against 29,566
(DCN-v2, batch 1,024): medians of 6 runs each way, whose spreads (2.7–5.4%)
are wider than any difference. The handover alone, on DLRM-UIH-sized
payloads with no trainer, took 0.6–1.2 ms more a batch with it on (its CUDA
events and laps, once an array) than the 1.1–1.3 ms it takes off (PERF.md
§6).
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.obs.clock import now_ns

STAGES: Tuple[str, ...] = ("scan", "featurize", "place", "h2d", "train")
# the phase ring's size: a 51 s window of DCN-v2's replayed step files about
# 6,300 phases, one of DLRM-UIH's feed about 6,800
PHASE_CAPACITY = 16384
HOST_STAGES: Tuple[str, ...] = ("scan", "featurize", "place")

_TLS = threading.local()


def current_span() -> Optional["ItemSpan"]:
    """The span of the work item this thread is currently processing, or
    None (telemetry off / item unsampled).  Stage recorders in the worker
    and client call this; it must stay allocation-free."""
    return getattr(_TLS, "span", None)


def current_seq() -> Optional[int]:
    """The seq of the work item this thread is processing, sampled or not
    (None: telemetry off or no item)."""
    return getattr(_TLS, "seq", None)


def current_phases() -> Optional["PhaseClock"]:
    """The phase clock this thread parked with ``PhaseClock.park``, or None
    (telemetry off): code called by the transfer thread laps and marks
    through it without knowing telemetry exists."""
    return getattr(_TLS, "phases", None)


class ItemSpan:
    """Span of one pool work item (a micro-batch of requests)."""

    __slots__ = ("seq", "t_mint", "stages", "attempts", "meta")

    def __init__(self, seq: int, t_mint: float) -> None:
        self.seq = seq
        self.t_mint = t_mint
        self.stages: Dict[str, Tuple[float, float]] = {}
        self.attempts = 0
        self.meta: Dict[str, Any] = {}

    def stage(self, name: str, t0: float, t1: float) -> None:
        self.stages[name] = (t0, t1)

    def stage_s(self, name: str) -> float:
        w = self.stages.get(name)
        return (w[1] - w[0]) if w else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"seq": self.seq, "t_mint": self.t_mint,
                "attempts": self.attempts,
                "stages": {k: list(v) for k, v in self.stages.items()},
                "meta": self.meta}


class BatchSpan:
    """Merged span of one emitted full batch: the item spans whose rows the
    batch contains, plus emit/deliver/train timestamps."""

    __slots__ = ("emit_seq", "items", "rows", "t_emit", "t_deliver",
                 "t_train_end", "sampled", "stages")

    def __init__(self, emit_seq: int, items: List[ItemSpan], rows: int,
                 t_emit: float) -> None:
        self.emit_seq = emit_seq
        self.items = items
        self.rows = rows
        self.t_emit = t_emit
        self.t_deliver: Optional[float] = None
        self.t_train_end: Optional[float] = None
        self.sampled = bool(items)
        # batch-level stages (h2d, train) — stages that see whole batches,
        # not work items
        self.stages: Dict[str, Tuple[float, float]] = {}

    def stage(self, name: str, t0: float, t1: float) -> None:
        self.stages[name] = (t0, t1)

    def stage_window(self, name: str) -> Optional[Tuple[float, float]]:
        if name in self.stages:
            return self.stages[name]
        ws = [sp.stages[name] for sp in self.items if name in sp.stages]
        if not ws:
            return None
        return (min(w[0] for w in ws), max(w[1] for w in ws))

    def stage_s(self, name: str) -> float:
        """Stage seconds: batch-level window if recorded, else total across
        contributing items (work time, not wall time)."""
        if name in self.stages:
            w = self.stages[name]
            return w[1] - w[0]
        return sum(sp.stage_s(name) for sp in self.items)

    def latency_s(self) -> Optional[float]:
        """Pipeline latency: first contributing scan start -> delivery."""
        if self.t_deliver is None:
            return None
        starts = [w[0] for sp in self.items for w in sp.stages.values()]
        if not starts:
            return None
        return self.t_deliver - min(starts)

    def to_dict(self) -> Dict[str, Any]:
        return {"emit_seq": self.emit_seq, "rows": self.rows,
                "t_emit": self.t_emit, "t_deliver": self.t_deliver,
                "t_train_end": self.t_train_end, "sampled": self.sampled,
                "latency_s": self.latency_s(),
                "stages": {k: list(v) for k, v in self.stages.items()},
                "items": [sp.to_dict() for sp in self.items]}


class PhaseSpan:
    """One phase of one thread: wall nanoseconds on ``obs.clock``, the
    thread's CPU nanoseconds over it, the id it belongs to (a step, a
    batch's ``emit_seq``, a work item's seq) and, once resolved, the device
    milliseconds of the CUDA intervals recorded inside it."""

    __slots__ = ("name", "thread", "t0_ns", "t1_ns", "cpu_ns", "id",
                 "device_ms")

    def __init__(self, name: str, thread: str, t0_ns: int, t1_ns: int,
                 cpu_ns: int, id: Any = None) -> None:
        self.name = name
        self.thread = thread
        self.t0_ns = t0_ns
        self.t1_ns = t1_ns
        self.cpu_ns = cpu_ns
        self.id = id
        self.device_ms: Optional[Dict[str, float]] = None

    def to_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "thread": self.thread, "t0_ns": self.t0_ns,
               "t1_ns": self.t1_ns, "cpu_ns": self.cpu_ns, "id": self.id}
        if self.device_ms is not None:
            out["device_ms"] = dict(self.device_ms)
        return out


class PhaseClock:
    """Consecutive phases of the calling thread, filed under one id.

    ``start()`` opens a cycle and its first phase; ``lap(name)`` closes the
    open phase as ``name`` and opens the next; ``commit(id)`` files the
    closed phases in the tracker's ring and ends the cycle. ``event`` makes
    a CUDA timing event (None off the card): ``mark(key)`` records one on
    the current stream, and the device time since the cycle's previous mark
    is added to ``device_ms[key]`` of the phase open at the mark (a mark
    without a key only sets the origin). One clock belongs to one thread."""

    __slots__ = ("tracker", "event", "open", "_t", "_c", "_laps", "_dev",
                 "_prev")

    def __init__(self, tracker: "SpanTracker",
                 event: Optional[Callable[[], Any]] = None) -> None:
        self.tracker = tracker
        self.event = event
        self.open = False

    def start(self, t_ns: Optional[int] = None) -> None:
        self._t = now_ns() if t_ns is None else t_ns
        self._c = time.thread_time_ns()
        self._laps: List[Tuple[str, int, int, int]] = []
        self._dev: List[Tuple[int, str, Any, Any]] = []
        self._prev = None
        self.open = True

    def lap(self, name: str) -> int:
        """Close the open phase as ``name``; returns the stamp (``now_ns``)
        that ends it and starts the next."""
        # the CPU clock is read inside the wall stamps on both sides, so a
        # phase's cpu_ns stays within its wall time
        c = time.thread_time_ns()
        t = now_ns()
        self._laps.append((name, self._t, t, c - self._c))
        self._t = t
        self._c = time.thread_time_ns()
        return t

    def mark(self, key: Optional[str] = None) -> None:
        if self.event is None:
            return
        e = self.event()
        e.record()
        if key is not None and self._prev is not None:
            self._dev.append((len(self._laps), key, self._prev, e))
        self._prev = e

    def commit(self, id: Any = None) -> List[PhaseSpan]:
        """File the cycle's phases, and resolve the device times that have
        completed, so that device marks wait in no queue longer than their
        events take."""
        thread = threading.current_thread().name
        spans = [self.tracker.phase(name, thread, t0, t1, cpu, id)
                 for name, t0, t1, cpu in self._laps]
        for i, key, e0, e1 in self._dev:
            if i < len(spans):
                self.tracker.device(spans[i], key, e0, e1)
        self.open = False
        if self._dev:
            self.tracker.resolve()
        return spans

    def park(self) -> None:
        """Make this the calling thread's ``current_phases()``."""
        _TLS.phases = self


class SpanTracker:
    """Mints item spans, threads them through the emission/delivery FIFOs,
    and keeps a bounded ring of completed batch spans and one of thread
    phases."""

    def __init__(self, sample_every: int = 8, capacity: int = 2048,
                 registry=None) -> None:
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.sample_every = sample_every
        self.registry = registry
        self._stage_hist = None    # lazy repro_stage_seconds family cache
        self.has_h2d = False
        self._lock = threading.Lock()
        self._items: Dict[int, ItemSpan] = {}      # minted, not yet placed
        self._emitted: Deque[BatchSpan] = collections.deque()
        self._h2d_done: Deque[BatchSpan] = collections.deque()
        self._await_train: Deque[BatchSpan] = collections.deque()
        self.completed: Deque[BatchSpan] = collections.deque(maxlen=capacity)
        # thread phases: the newest ``PHASE_CAPACITY``, the rest counted
        self.phases: Deque[PhaseSpan] = collections.deque(
            maxlen=PHASE_CAPACITY)
        self.phases_dropped = 0
        self._pending: Deque[Tuple[PhaseSpan, str, Any, Any]] = (
            collections.deque())
        # lifecycle accounting (orphan detection in tests / report)
        self.minted = 0
        self.abandoned = 0
        self.emitted_batches = 0
        self.delivered_batches = 0
        self.dropped_in_flight = 0

    # -- mint / worker-side -------------------------------------------------
    def mint(self, seq: int) -> Optional[ItemSpan]:
        if seq % self.sample_every:
            return None
        sp = ItemSpan(seq, now_ns() / 1e9)
        with self._lock:
            self._items[seq] = sp
            self.minted += 1
        return sp

    def get(self, seq: int) -> Optional[ItemSpan]:
        return self._items.get(seq)

    def enter_item(self, seq: int, attempt: bool = True) -> None:
        _TLS.seq = seq
        # unsampled fast path: skip the dict lookup (seven of eight items at
        # the default sampling — this is the per-item hot path)
        if seq % self.sample_every:
            _TLS.span = None
            return
        sp = self._items.get(seq)
        if sp is not None and attempt:
            sp.attempts += 1
        _TLS.span = sp

    def exit_item(self) -> None:
        _TLS.span = None
        _TLS.seq = None

    def current(self) -> Optional[ItemSpan]:
        return current_span()

    def abandon(self, seq: int) -> None:
        """Item exhausted its retries; its span is accounted, not orphaned."""
        if seq % self.sample_every:
            return
        with self._lock:
            if self._items.pop(seq, None) is not None:
                self.abandoned += 1

    def finish_item(self, seq: int) -> None:
        """Item fully placed — it no longer rides the live-item map (its
        span stays referenced by whatever BatchSpans it contributed to)."""
        if seq % self.sample_every:
            return
        with self._lock:
            self._items.pop(seq, None)

    # -- emission / consumption pipeline ------------------------------------
    def emit_batch(self, emit_seq: int, items: List[ItemSpan],
                   rows: int) -> BatchSpan:
        # unsampled batches are placeholders that only hold a FIFO position:
        # skip the clock read for them
        t = now_ns() / 1e9 if items else 0.0
        bs = BatchSpan(emit_seq, list(items), rows, t)
        with self._lock:
            self._emitted.append(bs)
            self.emitted_batches += 1
        return bs

    def pop_emitted(self) -> Optional[BatchSpan]:
        with self._lock:
            return self._emitted.popleft() if self._emitted else None

    def push_h2d_done(self, bs: Optional[BatchSpan]) -> None:
        if bs is None:
            return
        with self._lock:
            self._h2d_done.append(bs)

    def mark_delivered(self) -> Optional[BatchSpan]:
        with self._lock:
            q = self._h2d_done if self.has_h2d else self._emitted
            if not q:
                return None
            bs = q.popleft()
            if bs.sampled:
                bs.t_deliver = now_ns() / 1e9
            self._await_train.append(bs)
            self.delivered_batches += 1
        return bs

    def record_train(self, dt: float) -> Optional[BatchSpan]:
        with self._lock:
            if not self._await_train:
                return None
            bs = self._await_train.popleft()
        if bs.sampled:
            bs.t_train_end = now_ns() / 1e9
            bs.stage("train", bs.t_train_end - dt, bs.t_train_end)
            self._finalize(bs)
        return bs

    def _finalize(self, bs: BatchSpan) -> None:
        if not bs.sampled:
            return
        self.completed.append(bs)
        if self.registry is not None:
            hist = self._stage_hist
            if hist is None:
                hist = self._stage_hist = self.registry.histogram(
                    "repro_stage_seconds",
                    help="stage durations from sampled pipeline spans",
                    labels=("stage",))
            for sp in bs.items:
                for name in sp.stages:
                    hist.labels(stage=name).observe(sp.stage_s(name))
            for name in bs.stages:
                hist.labels(stage=name).observe(bs.stage_s(name))

    def drain(self) -> None:
        """Feed shut down: close out spans still riding the FIFOs.  Batches
        delivered but never trained finalize without a train stage; batches
        emitted but never delivered count as dropped in flight."""
        self.resolve(block=True)
        with self._lock:
            await_train = list(self._await_train)
            self._await_train.clear()
            dropped = list(self._emitted) + list(self._h2d_done)
            self._emitted.clear()
            self._h2d_done.clear()
            self.dropped_in_flight += len(dropped)
        for bs in await_train:
            self._finalize(bs)

    def orphan_items(self) -> List[ItemSpan]:
        """Spans minted but never placed NOR abandoned — must be empty after
        a drained run (the span-completeness invariant)."""
        with self._lock:
            return list(self._items.values())

    # -- thread phases -------------------------------------------------------
    def phase(self, name: str, thread: str, t0_ns: int, t1_ns: int,
              cpu_ns: int, id: Any = None) -> PhaseSpan:
        ps = PhaseSpan(name, thread, t0_ns, t1_ns, cpu_ns, id)
        with self._lock:
            if len(self.phases) == self.phases.maxlen:
                self.phases_dropped += 1
            self.phases.append(ps)
        return ps

    def device(self, span: PhaseSpan, key: str, start, end) -> None:
        """Add ``end``'s elapsed time since ``start`` (CUDA events) to
        ``span.device_ms[key]`` once ``end`` has completed."""
        with self._lock:
            self._pending.append((span, key, start, end))

    def resolve(self, block: bool = False) -> None:
        """Fill in the device times whose events have completed, in the
        order they were filed; ``block`` waits for the rest."""
        with self._lock:
            while self._pending:
                span, key, start, end = self._pending[0]
                if block:
                    end.synchronize()
                elif not end.query():
                    return
                self._pending.popleft()
                if span.device_ms is None:
                    span.device_ms = {}
                span.device_ms[key] = (span.device_ms.get(key, 0.0)
                                       + start.elapsed_time(end))

    def timeline(self) -> List[Dict[str, Any]]:
        """The ring's phases, oldest first, device times resolved."""
        self.resolve(block=True)
        with self._lock:
            return [ps.to_dict() for ps in self.phases]

    def write_timeline(self, path) -> None:
        with open(path, "w") as f:
            for rec in self.timeline():
                f.write(json.dumps(rec) + "\n")

    # -- analysis ------------------------------------------------------------
    def stage_totals(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for bs in list(self.completed):
            for sp in bs.items:
                for name in sp.stages:
                    totals[name] = totals.get(name, 0.0) + sp.stage_s(name)
            for name in bs.stages:
                totals[name] = totals.get(name, 0.0) + bs.stage_s(name)
        return totals

    def critical_path(self, *, starved_host_s: float = 0.0,
                      starved_h2d_s: float = 0.0,
                      starved_time_s: float = 0.0) -> Dict[str, Any]:
        """Attribute trainer starvation to pipeline stages.

        ``starved_h2d_s`` is attributed to the h2d stage outright; the host
        share splits across the host stages proportionally to their sampled
        span time (the stage the pipeline spends most host time in is the
        stage most likely to be the one the trainer waited on)."""
        return critical_path(self.stage_totals(),
                             starved_host_s=starved_host_s,
                             starved_h2d_s=starved_h2d_s,
                             starved_time_s=starved_time_s)

    def to_jsonl_lines(self) -> List[str]:
        return [json.dumps(bs.to_dict(), default=str)
                for bs in list(self.completed)]

    def write_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for line in self.to_jsonl_lines():
                f.write(line + "\n")

    def lifecycle_counts(self) -> Dict[str, int]:
        with self._lock:
            return {"minted": self.minted, "abandoned": self.abandoned,
                    "emitted_batches": self.emitted_batches,
                    "delivered_batches": self.delivered_batches,
                    "dropped_in_flight": self.dropped_in_flight,
                    "live_items": len(self._items),
                    "completed": len(self.completed),
                    "phases": len(self.phases),
                    "phases_dropped": self.phases_dropped}


def critical_path(stage_totals: Dict[str, float], *,
                  starved_host_s: float = 0.0, starved_h2d_s: float = 0.0,
                  starved_time_s: float = 0.0) -> Dict[str, Any]:
    """Pure attribution math (shared by the tracker and the report CLI)."""
    host_total = sum(stage_totals.get(s, 0.0) for s in HOST_STAGES)
    attribution: Dict[str, float] = {}
    if starved_h2d_s > 0:
        attribution["h2d"] = starved_h2d_s
    if starved_host_s > 0:
        if host_total > 0:
            for s in HOST_STAGES:
                share = stage_totals.get(s, 0.0) / host_total
                if share > 0:
                    attribution[s] = attribution.get(s, 0.0) + starved_host_s * share
        else:
            # No sampled host spans: attribute to scan, the stage that owns
            # the store round-trip and dominates cold pipelines.
            attribution["scan"] = attribution.get("scan", 0.0) + starved_host_s
    attributed = sum(attribution.values())
    dominant = max(attribution, key=attribution.get) if attribution else None
    frac = (attributed / starved_time_s) if starved_time_s > 0 else 1.0
    return {"stage_totals_s": dict(stage_totals),
            "attribution_s": attribution,
            "attributed_s": attributed,
            "starved_time_s": starved_time_s,
            "attributed_frac": min(1.0, frac),
            "dominant_stage": dominant}
