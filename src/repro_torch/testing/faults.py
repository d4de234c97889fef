"""Deterministic fault injection for the data plane (§10).

Chaos scenarios in this repo are *planned*, not raced: a ``FaultPlan`` is a
schedule of injected faults keyed to operation ticks (the Nth store scan, the
Nth stream consume), built either explicitly (``FaultSpec(kind, at)``) or from
a seed + per-kind rates (``FaultPlan.seeded``). ``FaultyStore`` /
``FaultyStream`` / ``FaultySim`` wrap the real objects and consult the plan at
every operation — any sim, store, or feed accepts the wrapper unchanged, so
every chaos test is a reproducible seed instead of a sleep-race.

Injectable kinds:

  * ``scan_ioerror``        — the Nth store scan raises ``InjectedIOError``
                              (transient remote-I/O failure);
  * ``decode_corruption``   — the Nth store scan raises ``DecodeCorruption``
                              (a stripe's payload failed its decode CRC; real
                              decoders detect this, they don't return garbage);
  * ``worker_crash``        — the Nth store scan raises ``WorkerCrash``,
                              killing the DPP worker thread mid-item;
  * ``compaction_during_scan`` — the plan's ``on_compact`` callback (e.g.
                              ``sim.run_compaction``) runs immediately before
                              the Nth scan: a generation flip races the read;
  * ``node_unavailable``    — the Nth store scan finds one store node of the
                              disaggregated tier down and raises
                              ``NodeUnavailable`` (retryable: the node is back
                              for the retry, no lease is leaked);
  * ``node_flap``           — store node ``spec.node`` goes DOWN at the Nth
                              scan tick and comes back (``recover()``: missed
                              loads replayed, orphan leases settled) after
                              ``spec.duration`` further ticks. Requires the
                              sharded tier; with replicas the flap is absorbed
                              by failover, at r=1 it degrades to the retry
                              path;
  * ``node_slow``           — store node ``spec.node`` serves every round-trip
                              ``spec.factor`` x slower for ``spec.duration``
                              ticks (a stuck disk / hot neighbor, not an
                              error): correctness is unaffected, hedged reads
                              are the mitigation;
  * ``stream_disconnect``   — the Nth stream consume raises
                              ``StreamDisconnect`` (healed in place by
                              ``StreamingSource``).

What is *recoverable*: all of the above. Scan-level faults surface as a dead
worker; ``DPPWorkerPool`` self-healing (``max_item_retries``) requeues the
item and respawns the worker, and ordered placement keeps the output
byte-identical to a fault-free run. Determinism caveat: the schedule (which
tick fires) is exact; with multiple worker threads, *which work item* owns a
given tick depends on scheduling — the harness's guarantee is that the output
is byte-identical regardless, which is precisely what the chaos tests assert.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.storage.protocol import NodeUnavailable
from repro_torch.storage.stream import StreamDisconnect


class InjectedFault(Exception):
    """Marker base for harness-injected failures."""


class InjectedIOError(InjectedFault, IOError):
    """Transient store-side I/O failure (remote scan timed out / reset)."""


class DecodeCorruption(InjectedFault, IOError):
    """A stripe blob failed its payload CRC during decode."""


class WorkerCrash(InjectedFault, RuntimeError):
    """Simulated hard death of the DPP worker processing the current item."""


SCAN_KINDS = ("compaction_during_scan", "scan_ioerror", "decode_corruption",
              "worker_crash", "node_unavailable", "node_flap", "node_slow")
CONSUME_KINDS = ("stream_disconnect",)
ALL_KINDS = SCAN_KINDS + CONSUME_KINDS
# kinds that flip durable node health state instead of raising at the caller
NODE_STATE_KINDS = ("node_flap", "node_slow")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` fires at 0-based tick ``at`` of its
    scope's operation counter (scan kinds count store scans, stream kinds
    count consumes). ``node``/``duration``/``factor`` only apply to the
    node-state kinds (``node_flap``, ``node_slow``): the state flips at tick
    ``at`` and restores ``duration`` ticks later."""

    kind: str
    at: int
    node: int = 0
    duration: int = 2
    factor: float = 8.0

    def __post_init__(self):
        if self.kind not in ALL_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {ALL_KINDS}")
        if self.at < 0:
            raise ValueError(f"fault tick must be >= 0, got {self.at}")
        if self.kind in NODE_STATE_KINDS and self.duration < 1:
            raise ValueError(
                f"{self.kind} duration must be >= 1 tick, got {self.duration}")
        if self.kind == "node_slow" and self.factor < 1.0:
            raise ValueError(
                f"node_slow factor must be >= 1, got {self.factor}")


class FaultPlan:
    """A thread-safe, reproducible schedule of injected faults.

    ``fired`` records every fault actually injected (for assertions);
    ``on_compact`` is the callback ``compaction_during_scan`` invokes
    (typically ``lambda: sim.run_compaction(...)``)."""

    def __init__(self, faults: Iterable[FaultSpec] = (),
                 on_compact: Optional[Callable[[], None]] = None):
        self.on_compact = on_compact
        # kind -> {tick: spec}: node-state kinds carry parameters, so the
        # full spec is kept (iterating a kind's entry still yields ticks)
        self._ticks: Dict[str, Dict[int, FaultSpec]] = {
            k: {} for k in ALL_KINDS}
        for f in faults:
            self._ticks[f.kind][f.at] = f
        self._counters = {"scan": 0, "consume": 0}
        self._lock = threading.Lock()
        self.fired: List[FaultSpec] = []

    @classmethod
    def seeded(cls, seed: int, rates: Dict[str, float], horizon: int,
               on_compact: Optional[Callable[[], None]] = None) -> "FaultPlan":
        """Draw a schedule from per-kind fault rates over ``horizon`` ticks:
        e.g. ``rates={"scan_ioerror": 0.01}`` fires at ~1% of scans. The same
        seed always produces the same schedule."""
        rng = np.random.default_rng(seed)
        faults: List[FaultSpec] = []
        for kind in sorted(rates):           # draw order fixed -> reproducible
            hits = np.nonzero(rng.random(horizon) < rates[kind])[0]
            faults.extend(FaultSpec(kind, int(t)) for t in hits)
        return cls(faults, on_compact=on_compact)

    def _fire(self, scope: str,
              kinds: Sequence[str]) -> Tuple[int, List[FaultSpec]]:
        with self._lock:
            t = self._counters[scope]
            self._counters[scope] = t + 1
            due = [self._ticks[k][t] for k in kinds if t in self._ticks[k]]
            self.fired.extend(due)
            return t, due

    def scan_tick(self) -> Tuple[int, List[FaultSpec]]:
        """Advance the scan-op counter; returns (tick, faults due at it)."""
        return self._fire("scan", SCAN_KINDS)

    def consume_tick(self) -> Tuple[int, List[FaultSpec]]:
        return self._fire("consume", CONSUME_KINDS)

    @property
    def n_fired(self) -> int:
        with self._lock:
            return len(self.fired)


class _Delegate:
    """Transparent wrapper base: unknown attribute reads AND writes pass
    through to the wrapped object (e.g. ``StreamingSource`` setting
    ``stream.track_freshness`` must reach the real stream)."""

    _OWN = ("inner", "fault_plan")

    def __init__(self, inner, fault_plan: FaultPlan):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "fault_plan", fault_plan)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        if name in type(self)._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)


class FaultyStore(_Delegate):
    """Wraps an ``ImmutableUIHStore``: every scan entry point first consults
    the plan (one tick per call — a batched multi-range scan is one remote
    round-trip, hence one failure domain).

    Node-state kinds (``node_flap``, ``node_slow``) do not raise here: they
    flip durable health state on the wrapped SHARDED store
    (``set_node_down``/``recover``/``set_node_slow``) and schedule their own
    restore ``duration`` ticks later — the failure surfaces (or doesn't)
    through the store's replica failover, exactly like production."""

    _OWN = ("inner", "fault_plan", "_restores", "_restore_lock")

    def __init__(self, inner, fault_plan: FaultPlan):
        super().__init__(inner, fault_plan)
        # [(restore_tick, fn)]: pending node-state restores
        object.__setattr__(self, "_restores", [])
        object.__setattr__(self, "_restore_lock", threading.Lock())

    def _flip_node_state(self, f: FaultSpec) -> None:
        store = self.inner
        if not hasattr(store, "set_node_down"):
            raise ValueError(
                f"fault kind {f.kind!r} needs the sharded store tier "
                f"(n_store_nodes > 0); got {type(store).__name__}")
        if f.kind == "node_flap":
            store.set_node_down(f.node)
            restore = lambda n=f.node: store.recover(n)   # noqa: E731
        else:   # node_slow
            store.set_node_slow(f.node, f.factor)
            restore = lambda n=f.node: store.set_node_slow(n, 1.0)  # noqa: E731
        self._restores.append((f.at + f.duration, restore))

    def _maybe_fault(self) -> None:
        tick, due = self.fault_plan.scan_tick()
        with self._restore_lock:
            # settle expired node-state faults BEFORE this tick's new ones:
            # a flap scheduled [at, at + duration) is back up at restore time
            still = [(at, fn) for at, fn in self._restores if tick < at]
            expired = [fn for at, fn in self._restores if tick >= at]
            self._restores[:] = still
            for fn in expired:
                fn()
            for f in due:
                if f.kind in NODE_STATE_KINDS:
                    self._flip_node_state(f)
        for f in due:
            if f.kind == "compaction_during_scan":
                cb = self.fault_plan.on_compact
                if cb is not None:
                    cb()
            elif f.kind == "scan_ioerror":
                raise InjectedIOError(
                    f"injected store IOError (scan tick {f.at})")
            elif f.kind == "decode_corruption":
                raise DecodeCorruption(
                    f"injected stripe decode corruption (scan tick {f.at})")
            elif f.kind == "worker_crash":
                raise WorkerCrash(
                    f"injected worker crash (scan tick {f.at})")
            elif f.kind == "node_unavailable":
                raise NodeUnavailable(
                    f"injected store-node outage (scan tick {f.at})")

    def settle_node_state(self) -> int:
        """Force-run node-state restores still pending (a flap/slow whose
        restore tick was never reached because the run ended first); returns
        how many were settled. Post-run audits that bypass the wrapper need
        the tier healthy."""
        with self._restore_lock:
            pending = [fn for _at, fn in self._restores]
            self._restores[:] = []
        for fn in pending:
            fn()
        return len(pending)

    def scan(self, req):
        self._maybe_fault()
        return self.inner.scan(req)

    def multi_range_scan(self, reqs, out_stats=None):
        self._maybe_fault()
        return self.inner.multi_range_scan(reqs, out_stats)

    def execute_plan(self, plan, out_stats=None):
        self._maybe_fault()
        return self.inner.execute_plan(plan, out_stats)


class FaultyStream(_Delegate):
    """Wraps a ``TrainingExampleStream``: the Nth ``consume`` raises
    ``StreamDisconnect`` (the broker keeps unacked messages; nothing is
    lost — the consumer reconnects and re-polls)."""

    def consume(self, timeout=None):
        _tick, due = self.fault_plan.consume_tick()
        for f in due:
            if f.kind == "stream_disconnect":
                raise StreamDisconnect(
                    f"injected stream disconnect (consume tick {f.at})")
        return self.inner.consume(timeout=timeout)


class FaultySim:
    """Chaos view of a ``ProductionSim``: the training read path (``immutable``
    store, ``stream``) goes through the fault wrappers; everything else —
    schema, warehouse, examples, snapshotter, compaction — delegates to the
    real sim, so inference and ingestion stay clean. Hand it to ``open_feed``
    in place of the sim."""

    def __init__(self, sim, fault_plan: FaultPlan):
        self.sim = sim
        self.fault_plan = fault_plan
        self.immutable = FaultyStore(sim.immutable, fault_plan)
        self.stream = FaultyStream(sim.stream, fault_plan)

    def __getattr__(self, name):
        return getattr(self.sim, name)


def wrap_sim(sim, fault_plan: FaultPlan) -> FaultySim:
    """Convenience: ``open_feed(spec, wrap_sim(sim, plan))``."""
    return FaultySim(sim, fault_plan)
