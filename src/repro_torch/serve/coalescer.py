"""Request coalescing: concurrent retrieval calls -> latency-bounded
micro-batches (DESIGN.md §14.2).

The serving analogue of ``streaming.source.MicroBatchConfig``: requests
arrive one at a time from independent caller threads and are flushed to a worker as
one micro-batch when EITHER the batch is full (``max_batch``) OR the oldest
queued request has waited ``max_delay_s`` (the deadline is set by the FIRST
request of the forming batch, so a trickle of lonely requests still meets the
latency bound). Unlike the streaming source there is no polling loop — a
condition variable wakes the worker exactly on submit/deadline/close.

``close()`` drains: queued requests keep flushing (``drain_flushes``) until
the queue is empty, then ``next_batch`` returns ``(None, "closed")`` and the
workers exit. A submit after close is refused so no request can be enqueued
with nobody left to answer it.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, List, Optional, Tuple


@dataclasses.dataclass
class CoalesceStats:
    submitted: int = 0          # requests accepted into the queue
    rejected: int = 0           # submits refused because the coalescer closed
    batches: int = 0            # micro-batches handed to workers
    size_flushes: int = 0       # flushed because the batch filled (max_batch)
    deadline_flushes: int = 0   # flushed because the oldest request timed out
    drain_flushes: int = 0      # flushed during close() drain


class PendingRequest:
    """One in-flight retrieval request: a tiny single-use future.

    The submitting thread blocks in ``result()``; the serving worker fills it
    via ``_resolve``/``_fail``."""

    __slots__ = ("user_id", "k", "request_ts", "enqueue_t", "done_t",
                 "_event", "_result", "_error")

    def __init__(self, user_id: int, k: int, request_ts: int) -> None:
        self.user_id = user_id
        self.k = k
        self.request_ts = request_ts
        self.enqueue_t = 0.0
        self.done_t = 0.0   # resolve/fail time: done_t - enqueue_t = latency
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"retrieval for user {self.user_id} not answered in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    # -- worker side --------------------------------------------------------
    def _resolve(self, result) -> None:
        self._result = result
        self.done_t = time.monotonic()
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        if self._event.is_set():
            return
        self._error = exc
        self.done_t = time.monotonic()
        self._event.set()


class RequestCoalescer:
    """Thread-safe deadline + max-batch micro-batcher."""

    def __init__(self, max_batch: int = 16, max_delay_s: float = 0.002):
        assert max_batch >= 1
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.stats = CoalesceStats()
        self._queue: Deque[PendingRequest] = collections.deque()
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)

    def submit(self, pending: PendingRequest) -> PendingRequest:
        with self._cond:
            if self._closed:
                self.stats.rejected += 1
                raise RuntimeError("coalescer is closed")
            pending.enqueue_t = time.monotonic()
            self._queue.append(pending)
            self.stats.submitted += 1
            self._cond.notify_all()
        return pending

    def next_batch(self) -> Tuple[Optional[List[PendingRequest]], str]:
        """Block until a micro-batch is ready; ``(None, "closed")`` once the
        coalescer is closed AND drained. Safe for multiple worker threads."""
        with self._cond:
            while True:
                if self._queue:
                    if self._closed:
                        flush = "drain"
                    elif len(self._queue) >= self.max_batch:
                        flush = "size"
                    else:
                        deadline = self._queue[0].enqueue_t + self.max_delay_s
                        now = time.monotonic()
                        if now < deadline:
                            self._cond.wait(timeout=deadline - now)
                            continue
                        flush = "deadline"
                    n = min(len(self._queue), self.max_batch)
                    batch = [self._queue.popleft() for _ in range(n)]
                    self.stats.batches += 1
                    if flush == "size":
                        self.stats.size_flushes += 1
                    elif flush == "deadline":
                        self.stats.deadline_flushes += 1
                    else:
                        self.stats.drain_flushes += 1
                    return batch, flush
                if self._closed:
                    return None, "closed"
                self._cond.wait()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
