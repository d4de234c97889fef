"""Per-node health tracking for the replicated store tier (DESIGN.md §12).

Two small, self-contained primitives the ``ShardedUIHStore`` failover
executor composes:

  * ``CircuitBreaker`` — consecutive-failure breaker per store node. CLOSED
    admits every request; ``threshold`` consecutive failures OPEN it, and an
    open breaker sheds load instantly (the failover executor skips straight
    to a replica instead of paying a timeout per request). After ``reset_s``
    the breaker HALF-OPENs and admits exactly ONE probe: success closes it,
    failure re-opens it (and restarts the reset clock).
  * ``LatencyTracker`` — a bounded window of recent node round-trip times,
    pooled tier-wide. ``quantile(q)`` is the hedging trigger: a request still
    in flight past the tier's q-quantile is presumed slow and a hedge fires
    at a replica. Hedging stays off until ``min_samples`` round-trips have
    been observed — an empty tracker must not hedge on noise.

Both are thread-safe; the breaker takes an injectable ``clock`` so its state
machine is unit-testable without sleeping.
"""
from __future__ import annotations

import bisect
import collections
import threading
import time
from typing import Deque, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure circuit breaker: open -> probe half-open -> close."""

    def __init__(self, threshold: int = 3, reset_s: float = 0.05,
                 clock=time.monotonic, listener=None):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.reset_s = reset_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive failures while closed
        self._opened_at = 0.0
        self._probing = False       # half-open probe currently admitted
        self.opens = 0              # lifetime closed/half-open -> open count
        # Optional ``listener(old_state, new_state)`` invoked outside the
        # breaker lock on every state transition — the sharded store points
        # this at the control-plane event log (DESIGN.md §13).
        self.listener = listener

    def _notify(self, old: str, new: str) -> None:
        if self.listener is not None and old != new:
            self.listener(old, new)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request be sent to this node right now? An OPEN breaker
        transitions to HALF_OPEN once ``reset_s`` has elapsed and admits a
        single probe; further requests are shed until the probe resolves."""
        with self._lock:
            old = self._state
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.reset_s:
                    self._state = HALF_OPEN
                    self._probing = True
                else:
                    return False
            elif self._probing:
                # HALF_OPEN: one probe at a time
                return False
            else:
                self._probing = True
                return True
        self._notify(old, HALF_OPEN)
        return True

    def record_success(self) -> None:
        with self._lock:
            old = self._state
            self._state = CLOSED
            self._failures = 0
            self._probing = False
        self._notify(old, CLOSED)

    def record_failure(self) -> bool:
        """Record a failed request; returns True when THIS failure opened the
        breaker (so the caller can count ``breaker_opens`` exactly once)."""
        with self._lock:
            old = self._state
            if self._state == HALF_OPEN:
                self._state = OPEN
                self._opened_at = self._clock()
                self._probing = False
                self.opens += 1
            elif self._state == OPEN:
                return False
            else:
                self._failures += 1
                if self._failures < self.threshold:
                    return False
                self._state = OPEN
                self._opened_at = self._clock()
                self.opens += 1
        self._notify(old, OPEN)
        return True

    def reset(self) -> None:
        """Administrative close (node recovered out-of-band)."""
        with self._lock:
            old = self._state
            self._state = CLOSED
            self._failures = 0
            self._probing = False
        self._notify(old, CLOSED)

    def __repr__(self) -> str:
        return (f"CircuitBreaker(state={self.state}, "
                f"threshold={self.threshold}, opens={self.opens})")


class LatencyTracker:
    """Bounded sliding window of round-trip latencies with quantile reads."""

    def __init__(self, window: int = 256, min_samples: int = 16):
        self.min_samples = min_samples
        self._lock = threading.Lock()
        self._samples: Deque[float] = collections.deque(maxlen=window)

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile of the window, or None while the window holds
        fewer than ``min_samples`` observations (hedging must not trigger
        off a cold tracker)."""
        with self._lock:
            if len(self._samples) < max(self.min_samples, 1):
                return None
            ordered = sorted(self._samples)
        idx = min(len(ordered) - 1, max(0, int(q * len(ordered))))
        return ordered[idx]

    def observed_at_least(self, seconds: float) -> int:
        """How many window samples are >= ``seconds`` (introspection)."""
        with self._lock:
            ordered = sorted(self._samples)
        return len(ordered) - bisect.bisect_left(ordered, seconds)
