"""Control-plane event log: bounded ring buffer + JSONL sink (DESIGN.md §13).

Counters say *how many* breaker opens happened; the event log says *when*,
*on which node*, and *in what order relative to everything else* — the
timeline that turns "hedge_wins=3, worker_restarts=2" into a story a human
can debug from.  Producers call ``emit(kind, **fields)`` from any thread;
each record gets a process-monotonic sequence number, a ``time.monotonic()``
timestamp (ordering; never goes backwards) and a ``time.time()`` wall stamp
(cross-process correlation).  The ring holds the most recent ``capacity``
events; ``to_jsonl_lines`` / ``write_jsonl`` dump it for the report CLI.

Event kinds emitted by the wired data plane (one line each in the run's
``events.jsonl``): ``generation_flip``, ``lease_acquire``, ``lease_release``,
``breaker_open``, ``breaker_half_open``, ``breaker_close``, ``failover``,
``hedge_win``, ``degraded_scan``, ``partial_reissue``, ``node_down``,
``node_recover``, ``worker_crash``, ``item_requeued``, ``item_abandoned``,
``worker_restart``, ``backfill_flip``, ``stream_reconnect``,
``checkpoint_save``, ``checkpoint_resume``.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Deque, Dict, List, Optional


class Event:
    __slots__ = ("seq", "t_mono", "t_wall", "kind", "fields")

    def __init__(self, seq: int, t_mono: float, t_wall: float, kind: str,
                 fields: Dict[str, Any]) -> None:
        self.seq = seq
        self.t_mono = t_mono
        self.t_wall = t_wall
        self.kind = kind
        self.fields = fields

    def to_dict(self) -> Dict[str, Any]:
        return {"seq": self.seq, "t_mono": self.t_mono, "t_wall": self.t_wall,
                "kind": self.kind, **self.fields}

    def __repr__(self) -> str:
        return f"Event({self.seq}, {self.kind}, {self.fields})"


class EventLog:
    """Thread-safe bounded ring of control-plane events."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self._ring: Deque[Event] = collections.deque(maxlen=capacity)
        self._seq = 0
        self._emitted = 0
        self._lock = threading.Lock()

    def emit(self, kind: str, **fields: Any) -> Event:
        t_mono = time.monotonic()
        t_wall = time.time()
        with self._lock:
            self._seq += 1
            self._emitted += 1
            ev = Event(self._seq, t_mono, t_wall, kind, fields)
            self._ring.append(ev)
        return ev

    @property
    def emitted(self) -> int:
        """Lifetime emit count (>= len(snapshot()) once the ring wraps)."""
        return self._emitted

    def snapshot(self) -> List[Event]:
        with self._lock:
            return list(self._ring)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.snapshot():
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    def to_jsonl_lines(self) -> List[str]:
        return [json.dumps(ev.to_dict(), default=str)
                for ev in self.snapshot()]

    def write_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for line in self.to_jsonl_lines():
                f.write(line + "\n")
