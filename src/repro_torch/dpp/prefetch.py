"""Double-buffered device feed (paper §4.2): overlap host->device transfer for
batch N+1 with the train step for batch N.

Port of ``repro.dpp.prefetch``. ``DevicePrefetcher`` sits between a
host-batch source (typically a ``RebatchingClient``) and the ``Trainer``: a
background thread pulls the next host batch, applies an optional ``prep_fn``,
and issues the device transfer — all while the previous step computes.
``depth`` bounds how many device batches may be in flight.

CUDA handover. The transfer thread owns a side ``torch.cuda.Stream``: the
pinned non-blocking copies and the fused kernel run there. After each batch
the thread records an event and waits for it, so the H2D time lands in the
prefetcher's clock (as ``block_until_ready`` did in the reference) and a
recycled host slot is never still being read. The consumer's ``get`` makes
its current stream wait on the event and calls ``record_stream`` on every
handed-over tensor, so the caching allocator does not reuse a batch's memory
while the step still reads it. On the CPU there are no streams or events.

Starvation attribution: the prefetch thread runs a state clock (host-fetch vs
H2D-copy); when the consumer blocks, the wait is split into
``ClientStats.starved_host_s`` vs ``starved_h2d_s`` proportionally to what the
prefetcher was doing during the wait window.

Slot recycling: when the source exposes ``recycle`` and ``recycle_host=True``,
the host storage of a transferred batch is returned to the source's slot pool
after the copy's event has completed. On the CPU the "device" batch aliases
the host arrays, so recycling would corrupt in-flight batches — hence the
conservative default.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.dpp.client import ClientStats
from repro_torch.dpp.device_mat import is_jagged_batch, to_device

HostBatch = Dict[str, np.ndarray]


class _StateClock:
    """Cumulative time-in-state tracker readable mid-state from other threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._acc: Dict[str, float] = {}
        self._state: Optional[str] = None
        self._since = 0.0

    def enter(self, state: Optional[str]) -> None:
        now = time.perf_counter()
        with self._lock:
            if self._state is not None:
                self._acc[self._state] = (
                    self._acc.get(self._state, 0.0) + now - self._since)
            self._state = state
            self._since = now

    def snapshot(self) -> Dict[str, float]:
        now = time.perf_counter()
        with self._lock:
            out = dict(self._acc)
            if self._state is not None:
                out[self._state] = out.get(self._state, 0.0) + now - self._since
            return out


class _SourceError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class _Ready:
    """A device batch plus the event that marks its copies complete."""

    def __init__(self, batch: Any, event: Optional[torch.cuda.Event]):
        self.batch = batch
        self.event = event


class DevicePrefetcher:
    """Pull host batches from ``source``, transfer to ``device`` in a
    background thread, yield ready device batches.

    ``source`` is either a ``RebatchingClient``-like object (``get_full_batch``
    returning ``None`` at end of stream) or any iterable of host batches.
    """

    def __init__(
        self,
        source: Any,
        depth: int = 2,
        device: Any = "cuda",
        prep_fn: Optional[Callable[[HostBatch], Any]] = None,
        stats: Optional[ClientStats] = None,
        recycle_host: bool = False,
        materialize: Any = None,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.source = source
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the transfer thread must name its card: take the caller's
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.prep_fn = prep_fn
        self.recycle_host = recycle_host
        # device-side late materialization: a DeviceMaterializer that turns
        # compact jagged payloads (arena + offsets) into dense device batches
        # with the kernels/fused CUDA kernel — dense batches (or a None
        # materializer) take the plain path below
        self.materialize = materialize
        self.stats = stats if stats is not None else (
            getattr(source, "stats", None) or ClientStats())
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._clock = _StateClock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._started = False
        self._stream: Optional[torch.cuda.Stream] = None
        self._telemetry = None
        self._h2d_hist = None
        # end-of-stream sentinel observed by the consumer (vs a get timeout)
        self.ended = False

    # -- telemetry ----------------------------------------------------------------
    @property
    def telemetry(self):
        return self._telemetry

    @telemetry.setter
    def telemetry(self, tel) -> None:
        """Attach a ``repro_torch.obs.Telemetry``. Must happen BEFORE
        ``start()``: the span tracker's delivery FIFO switches to the H2D-done
        lane (``has_h2d``) and emitted/consumed counts must match."""
        self._telemetry = tel
        if tel is not None:
            tel.spans.has_h2d = True
            self._h2d_hist = tel.registry.histogram(
                "repro_h2d_seconds",
                help="host->device transfer time per full batch")

    # -- producer (background transfer thread) -----------------------------------
    def _pull(self):
        get = getattr(self.source, "get_full_batch", None)
        if get is not None:
            # record=False: the PREFETCH thread's wait on host data is not GPU
            # starvation — only the consumer-side wait below is
            try:
                return get(record=False)
            except TypeError:
                return get()
        it = getattr(self, "_source_iter", None)
        if it is None:
            it = self._source_iter = iter(self.source)
        return next(it, None)

    def _transfer(self, host_batch: HostBatch) -> Any:
        if self.materialize is not None and is_jagged_batch(host_batch):
            # compact jagged payload: upload arena+offsets only, densify and
            # delta-decode ON DEVICE (kernels/fused); the [B, L] zero padding
            # never crosses the link
            dev = self.materialize(host_batch)
            self.stats.h2d_bytes += self.materialize.last_h2d_bytes
            return dev
        prepped = self.prep_fn(host_batch) if self.prep_fn else host_batch
        if not isinstance(prepped, dict):
            raise TypeError("DevicePrefetcher transfers dict batches, got "
                            f"{type(prepped).__name__}")
        dev = {k: to_device(np.asarray(v), self.device)
               for k, v in prepped.items()}
        self.stats.h2d_bytes += sum(
            getattr(v, "nbytes", 0) for v in prepped.values())
        return dev

    def _transfer_ready(self, host_batch: HostBatch) -> _Ready:
        """Transfer on the side stream and wait for it (CUDA), or directly."""
        if self._stream is None:
            return _Ready(self._transfer(host_batch), None)
        with torch.cuda.stream(self._stream):
            dev = self._transfer(host_batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        # block in THIS thread so the consumer receives resident buffers and
        # the H2D cost lands in the prefetcher's clock, not the train step
        event.synchronize()
        return _Ready(dev, event)

    def _loop(self) -> None:
        try:
            if self.device.type == "cuda":
                # before the thread's first CUDA call: streams, pinned copies
                # and kernel launches all target this card
                torch.cuda.set_device(self.device)
                self._stream = torch.cuda.Stream(device=self.device)
            while not self._stop.is_set():
                self._clock.enter("host")
                host_batch = self._pull()
                if host_batch is None:
                    break
                tel = self._telemetry
                bs = tel.spans.pop_emitted() if tel is not None else None
                self._clock.enter("h2d")
                t0 = time.perf_counter()
                ready = self._transfer_ready(host_batch)
                t1 = time.perf_counter()
                self.stats.h2d_time_s += t1 - t0
                if tel is not None:
                    if bs is not None:
                        bs.stage("h2d", t0, t1)
                        tel.spans.push_h2d_done(bs)
                    self._h2d_hist.observe(t1 - t0)
                if self.recycle_host:
                    rec = getattr(self.source, "recycle", None)
                    if rec is not None:
                        # safe: _transfer_ready waited for the copy's event
                        rec(host_batch)
                self._clock.enter("idle")
                if not self._offer(ready):
                    return     # stopped while the queue was full
        except BaseException as e:  # propagate to the consumer
            self._clock.enter("idle")
            self._offer(_SourceError(e))
            return
        self._clock.enter(None)
        self._offer(None)

    def _offer(self, item) -> bool:
        """put that re-checks stop: a consumer that walked away (e.g. fit hit
        max_steps) must not leave this thread parked on a full queue pinning
        device buffers forever."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer (trainer loop) --------------------------------------------------
    def start(self) -> "DevicePrefetcher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def _hand_over(self, ready: _Ready) -> Any:
        """Order the consumer's stream after the batch's copies and tell the
        caching allocator the consumer's stream uses its tensors."""
        if ready.event is None:
            return ready.batch
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(ready.event)
        for v in ready.batch.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(consumer)
        return ready.batch

    def get(self, timeout: Optional[float] = None, record: bool = True):
        """Next device-resident batch, or ``None`` at end of stream.

        ``record=False`` suppresses the starvation/full-batch accounting —
        for pulls that are NOT the trainer's critical path."""
        self.start()
        before = self._clock.snapshot()
        t0 = time.perf_counter()
        try:
            out = self._q.get(timeout=timeout)
            if out is None:
                self.ended = True
        except queue.Empty:
            return None
        dt = time.perf_counter() - t0
        if isinstance(out, _SourceError):
            self.stop()
            raise RuntimeError("device prefetch source failed") from out.exc
        if out is None:
            return None
        if record:
            # split the consumer's wait by what the prefetcher was doing
            after = self._clock.snapshot()
            d_host = after.get("host", 0.0) - before.get("host", 0.0)
            d_h2d = after.get("h2d", 0.0) - before.get("h2d", 0.0)
            busy = d_host + d_h2d
            host_share = dt * (d_host / busy) if busy > 0 else dt
            self.stats.starved_time_s += dt
            self.stats.starved_host_s += host_share
            self.stats.starved_h2d_s += dt - host_share
            self.stats.full_batches += 1
        return self._hand_over(out)

    def record_train_step(self, seconds: float) -> None:
        rec = getattr(self.source, "record_train_step", None)
        if rec is not None and getattr(self.source, "stats", None) is self.stats:
            # the source owns the shared ClientStats: DELEGATE instead of
            # recording here — train time is a single global clock
            rec(seconds)
            return
        self.stats.train_time_s += seconds
        if rec is not None:
            rec(seconds)

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def stop(self, timeout: float = 5.0) -> None:
        """Abandon the stream: stop the transfer thread and release queued
        device batches (safe to call from the consumer at any point).

        Drains AFTER the thread exits — a drain racing a producer parked in
        ``_q.put`` would free a queue slot, let that put land, and strand one
        device-resident batch forever. If the thread is stuck in a host
        source that never yields, it parks as a daemon on an empty queue."""
        self._stop.set()
        if self._started:
            deadline = time.monotonic() + timeout
            while self._thread.is_alive() and time.monotonic() < deadline:
                self._drain()
                self._thread.join(timeout=0.05)
        self._drain()

    def __iter__(self) -> Iterator[Any]:
        while True:
            b = self.get()
            if b is None:
                return
            yield b
