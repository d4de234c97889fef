"""Disaggregated immutable tier: a replicated multi-node sharded store (§4.2.3).

The paper's normalized immutable UIH tier is a horizontally sharded service;
this module splits the in-process monolith into:

  * ``StoreNode`` — one storage node, owning its resident shard tables, its
    stripe-decode LRU, its per-node ``IOStats`` and its generation/lease
    state. A node is a full ``ImmutableUIHStore`` (bulk load, planned batch
    scans over its *local* shards, leases) that happens to hold only the
    users placed on it.
  * ``ShardedUIHStore`` — the client every consumer actually talks to. It
    implements the complete ``StoreProtocol`` surface (``plan`` /
    ``execute_plan`` / ``scan`` / ``bulk_load`` / ``acquire_lease`` /
    ``estimate_scan`` / generations / introspection) by routing requests to
    nodes through a per-generation ``PlacementMap`` and executing node groups
    concurrently — one remote round-trip per node, nodes overlapped on a
    thread pool, each node further parallelizing across its local shards.

**Placement** (FlexShard-style, 2301.02959): the torso routes by symmetric
hash (``shard_of`` -> ``node_of_shard``); the heavy tail of ultra-long users
gets an explicit balanced assignment recomputed from the generation's actual
stripe bytes (``length_aware_overrides``). The resulting map is generation
metadata: the client retains the map of every live/retained generation, so a
pinned scan finds its bytes on the node where *that* generation placed them
even after a later ``rebalance()`` moved the user.

**Replication** (``replication_factor`` = r): every bulk load installs each
user's stripes on the r nodes of the user's replica chain —
``PlacementMap.replicas_of``: LPT-placed primary, then round-robin
anti-affine successors, all distinct nodes. Leases pin on every node, so any
replica can serve a pinned scan.

**Failover** (DESIGN.md §12): reads go through a health-aware executor. Each
node has a consecutive-failure ``CircuitBreaker`` (open -> probe half-open ->
close); a failed or breaker-open primary re-routes to the next live replica
(``failovers``), a whole failed node group is re-issued after seeded
deterministic backoff WITHOUT re-running its completed siblings
(``partial_reissues``), and — opt-in via ``hedge_quantile`` — a request
still in flight past the tier's latency quantile fires a speculative replica
read (``hedged_reads`` / ``hedge_wins``). Only when every replica in the
chain fails does the read raise ``NodeUnavailable`` (``degraded_scans``) —
the *retryable* class, so the DPP pool's self-healing takes over and
output stays byte-identical once a replica returns. ``GenerationUnavailable``
still means the data is gone (remediation), but the executor first checks the
survivors: a pinned generation GC'd on a recovered node is served by the
replica that still retains it.

**Epoch barrier**: ``bulk_load`` and ``acquire_lease`` serialize on one flip
lock. A lease therefore pins the SAME generation on every node — there is no
interleaving where node 0 leases generation g while node 1 has already
flipped to g+1 — which is exactly the consistency the snapshotter's
transient lease and the streaming pin protocol assume. The lock is
never taken on the scan path: reads stay lock-free exactly like the
monolith's. A node that is down is *excluded* from the barrier rather than
blocking it: its missed loads queue for replay and its missed lease releases
park as orphans, both settled by ``recover()``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import wait as futures_wait
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import events as ev
from repro_torch.core.backoff import Backoff
from repro_torch.obs.registry import Histogram
from repro_torch.storage.failover import CircuitBreaker
from repro_torch.storage.immutable_store import (
    GenerationUnavailable,
    ImmutableUIHStore,
    IOStats,
    LeaseStats,
    ScanPlan,
    ScanRequest,
    build_scan_plan,
)
from repro_torch.storage.protocol import NodeUnavailable  # noqa: F401  (re-export:
#   the exception is part of the storage protocol now; this module keeps the
#   historical import path alive for existing consumers)
from repro_torch.storage.sharding import (
    PlacementMap,
    ShardRouter,
    length_aware_overrides,
)


class StoreNode(ImmutableUIHStore):
    """One node of the disaggregated immutable tier.

    Owns everything node-local: shard tables for the users placed here, the
    stripe-decode LRU, per-node ``IOStats``, and this node's generation /
    lease state. ``n_shards`` is the node's LOCAL shard count (its internal
    scan parallelism); global routing is the client's job."""

    # decorrelates the node-LOCAL shard hash from the global placement hash:
    # a node's residents all agree on shard_of(u, n_global) mod n_nodes, and
    # nested moduli of the same mix value collapse them into one local shard
    # (see ShardRouter.salt) — killing the node's internal scan parallelism
    LOCAL_SALT = 0x5DEECE66D

    def __init__(self, node_id: int, schema=None, n_shards: int = 2,
                 decode_cache_size: int = 256):
        super().__init__(schema, n_shards=n_shards,
                         decode_cache_size=decode_cache_size)
        self.router = ShardRouter(n_shards, salt=self.LOCAL_SALT)
        self.node_id = node_id

    def __repr__(self) -> str:
        return (f"StoreNode(id={self.node_id}, gen={self.generation}, "
                f"local_shards={self.n_shards})")


@dataclasses.dataclass
class NodeStats:
    """Per-node skew + health surface: who is doing the work, who holds the
    bytes, and which nodes the failover executor currently trusts.

    ``max_mean_*_ratio`` is the p-max load metric the placement policy
    optimizes: 1.0 = perfectly even, N = one node carries everything."""

    per_node: List[IOStats]          # each node's cumulative IOStats snapshot
    scan_load: List[int]             # bytes_scanned per node (read skew)
    seeks: List[int]                 # seeks per node
    decodes: List[int]               # stripes decoded per node
    stored: List[int]                # resident blob bytes per node (placement)
    max_mean_load_ratio: float       # max/mean of scan_load
    max_mean_stored_ratio: float     # max/mean of stored
    # -- health (replicated tier, DESIGN.md §12) ------------------------------
    down: List[bool] = dataclasses.field(default_factory=list)
    breaker: List[str] = dataclasses.field(default_factory=list)
    breaker_opens: List[int] = dataclasses.field(default_factory=list)
    pending_replays: List[int] = dataclasses.field(default_factory=list)

    @staticmethod
    def _ratio(values: Sequence[int]) -> float:
        mean = sum(values) / max(len(values), 1)
        return (max(values) / mean) if mean > 0 else 1.0


class ShardedGenerationLease:
    """One logical lease = one node lease on EVERY reachable node, acquired
    under the flip lock so all of them name the same generation (epoch
    barrier). Release fans back in across the survivors: a node that died
    while leased gets its release parked as an orphan and settled by
    ``recover()`` — nothing leaks either way."""

    __slots__ = ("generation", "_store", "_node_leases", "_released")

    def __init__(self, store: "ShardedUIHStore", generation: int, node_leases):
        self.generation = generation
        self._store = store
        self._node_leases = node_leases   # [(node_id, node lease), ...]
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._store._release_client_lease(self.generation,
                                              self._node_leases)

    def __enter__(self) -> "ShardedGenerationLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class ShardedUIHStore:
    """Replicated multi-node client for the disaggregated immutable tier.

    Drop-in for ``ImmutableUIHStore`` everywhere the ``StoreProtocol`` is
    spoken — same plan/execute/lease surface, same ``StaleGeneration``
    remediation contract — with reads fanned out across ``n_nodes`` store
    nodes, r-way replication, and a health-aware failover executor that
    keeps reads available through node loss (see module docstring)."""

    def __init__(
        self,
        schema=None,
        n_shards: int = 8,
        n_nodes: int = 4,
        decode_cache_size: int = 256,
        placement_policy: str = "length_aware",   # "length_aware" | "hash"
        heavy_tail_fraction: float = 0.05,
        replication_factor: int = 1,
        hedge_quantile: float = 0.0,     # 0 disables hedged reads
        max_group_retries: int = 2,      # re-issues of a failed node group
        breaker_threshold: int = 3,
        breaker_reset_s: float = 0.05,
        backoff: Optional[Backoff] = None,
    ):
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        if placement_policy not in ("length_aware", "hash"):
            raise ValueError(f"unknown placement_policy {placement_policy!r}")
        if not 1 <= replication_factor <= n_nodes:
            raise ValueError(
                f"replication_factor must be in [1, n_nodes={n_nodes}], "
                f"got {replication_factor}")
        if not 0.0 <= hedge_quantile < 1.0:
            raise ValueError(
                f"hedge_quantile must be in [0, 1), got {hedge_quantile}")
        self.schema = (schema if schema is not None
                       else ev.default_schema())
        self.n_shards = n_shards
        self.n_nodes = n_nodes
        self.router = ShardRouter(n_shards)   # symmetric data-placement key
        self.placement_policy = placement_policy
        self.heavy_tail_fraction = heavy_tail_fraction
        self.replication_factor = replication_factor
        self.hedge_quantile = hedge_quantile
        self.max_group_retries = max_group_retries
        local_shards = max(1, n_shards // n_nodes)
        self.nodes: List[StoreNode] = [
            StoreNode(i, self.schema, n_shards=local_shards,
                      decode_cache_size=decode_cache_size)
            for i in range(n_nodes)
        ]
        self.generation = -1
        # epoch barrier: generation flips and lease acquisition serialize here
        # (the scan path never takes it — reads stay lock-free per node)
        self._flip_lock = threading.Lock()
        self._lease_refs: Dict[int, int] = {}     # gen -> logical lease refs
        self._lease_ls = LeaseStats()
        # placement is generation metadata: retained as long as the
        # generation is live or lease-retained anywhere
        self._live_placement = PlacementMap(n_nodes, n_shards, {},
                                            replication_factor)
        self._placements: Dict[int, PlacementMap] = {}
        self._rebalance_pending = False
        # -- health state (DESIGN.md §12) ------------------------------------
        self._down = [False] * n_nodes
        self._slow = [1.0] * n_nodes         # injected latency multipliers
        self._breakers = [CircuitBreaker(breaker_threshold, breaker_reset_s)
                          for _ in range(n_nodes)]
        # Tier-wide RTT histogram (the hedge trigger). A registry-grade
        # Histogram with a bounded exact-quantile window — same semantics
        # the old ad-hoc LatencyTracker had (None below min_samples); when a
        # Telemetry object is attached it is re-homed into the run registry
        # as ``repro_store_rtt_seconds``.
        self._latency = Histogram(window=256, min_samples=16)
        self._telemetry = None
        self._backoff = backoff or Backoff(base_s=0.002, max_s=0.05)
        # bulk loads a down node missed, replayed in order by recover()
        self._pending_loads: List[List[Tuple[int, dict]]] = [
            [] for _ in range(n_nodes)]
        # node leases whose release fanned in while the node was down
        self._orphan_leases: List[List] = [[] for _ in range(n_nodes)]
        self.rereplications = 0        # generations replayed by recover()
        self.rereplicated_bytes = 0    # stripe bytes re-pushed by recover()
        self._stats_lock = threading.Lock()
        self._client_plan_stats = IOStats()   # batched_requests/dedup/subsumed
        self._failover_stats = IOStats()      # failovers/hedges/breaker/degraded
        self._pool = ThreadPoolExecutor(
            max_workers=min(n_nodes, 16), thread_name_prefix="uih-node")
        # hedged + timed attempts run here so a group thread can wait on its
        # primary with a deadline; threads spawn lazily, so the pool is free
        # until the first hedge-eligible call
        self._hedge_pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * min(n_nodes, 16)),
            thread_name_prefix="uih-hedge")

    # -- placement -----------------------------------------------------------
    def live_placement(self) -> PlacementMap:
        return self._live_placement

    def placement_for(self, generation: int) -> PlacementMap:
        """The map that generation's bulk load placed users with (live map
        for -1/unknown: an unknown pinned generation is GC'd, and its scan
        will raise ``GenerationUnavailable`` wherever it lands)."""
        if generation < 0:
            return self._live_placement
        return self._placements.get(generation, self._live_placement)

    def rebalance(self) -> Dict[int, int]:
        """Recompute heavy-tail placement at the NEXT generation flip.

        Placement is otherwise sticky across flips (daily compaction must not
        reshuffle the torso's working set); ``rebalance()`` marks the next
        ``bulk_load`` to re-derive the override map from the new generation's
        actual stripe bytes. Returns a preview computed from the LIVE tables
        so operators can see the planned moves."""
        with self._flip_lock:
            self._rebalance_pending = True
            loads = self._live_loads()
        return length_aware_overrides(
            loads, self.n_nodes, self.n_shards, self.heavy_tail_fraction)

    def _live_loads(self) -> Dict[int, int]:
        # with replication every user appears on r nodes; the uniform r-fold
        # scaling cancels in the LPT balance decisions and the mean threshold
        loads: Dict[int, int] = {}
        for node in self.nodes:
            for shard in node._shards:
                for (uid, _group), (_starts, stripes) in shard.items():
                    loads[uid] = loads.get(uid, 0) + sum(
                        len(s.blob) for s in stripes)
        return loads

    # -- node routing ---------------------------------------------------------
    def _node_of(self, user_id: int, generation: int = -1) -> int:
        return self.placement_for(generation).node_of(user_id)

    def _node_for(self, user_id: int, generation: int = -1) -> StoreNode:
        return self.nodes[self._node_of(user_id, generation)]

    # -- telemetry (DESIGN.md §13) --------------------------------------------
    @property
    def telemetry(self):
        return self._telemetry

    @telemetry.setter
    def telemetry(self, tel) -> None:
        self._telemetry = tel
        if tel is None:
            return
        # Re-home the hedge-trigger RTT histogram into the run registry and
        # point every breaker's transition listener at the event log.
        self._latency = tel.registry.histogram(
            "repro_store_rtt_seconds",
            help="per-attempt store-node round-trip time (hedge trigger)",
            window=256, min_samples=16)
        for nid, breaker in enumerate(self._breakers):
            breaker.listener = self._breaker_listener(nid)

    def _breaker_listener(self, node_id: int):
        def _on_transition(old: str, new: str) -> None:
            self._emit(f"breaker_{new}", node=node_id, prev=old)
        return _on_transition

    def _emit(self, kind: str, **fields) -> None:
        tel = self._telemetry
        if tel is not None:
            tel.events.emit(kind, **fields)

    def publish_telemetry(self) -> None:
        """Publish tier + per-node IOStats and health counters into the
        attached run registry (labels: store / node)."""
        tel = self._telemetry
        if tel is None:
            return
        tel.publish_stats(self.stats, "io", store="sharded")
        tel.publish_stats(self.lease_stats, "lease", store="sharded")
        for nid, node in enumerate(self.nodes):
            tel.publish_stats(node.stats.snapshot(), "io_node", node=nid)
        down_g = tel.registry.gauge("repro_store_node_down", labels=("node",))
        opens_c = tel.registry.counter("repro_store_breaker_opens_total",
                                       labels=("node",))
        for nid in range(self.n_nodes):
            down_g.labels(node=nid).set(1.0 if self._down[nid] else 0.0)
            opens_c.labels(node=nid).set_total(self._breakers[nid].opens)

    # -- health surface --------------------------------------------------------
    def set_node_down(self, node_id: int, down: bool = True) -> None:
        """Mark a node unreachable: its reads raise ``NodeUnavailable`` (and
        with replicas, fail over) until it returns. Marking a node back up
        goes through ``recover()`` — replaying missed loads and settling
        orphaned leases, never just flipping the flag."""
        if not down:
            self.recover(node_id)
            return
        self._down[node_id] = True
        self._emit("node_down", node=node_id)

    def set_node_slow(self, node_id: int, multiplier: float = 1.0) -> None:
        """Inject a latency multiplier on one node (the ``node_slow`` chaos
        kind): every round-trip through it is stretched by ``multiplier``.
        1.0 restores full speed. Slow responses still feed the tier's latency
        tracker, which is exactly how quantile-triggered hedging notices."""
        if multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1, got {multiplier}")
        self._slow[node_id] = float(multiplier)

    def recover(self, node_id: int) -> int:
        """Bring a node back into the tier. Re-replication bookkeeping:
        bulk loads the node missed while down are replayed in order
        (``rereplications`` / ``rereplicated_bytes``), lease releases that
        fanned in while it was dead are settled (the orphans parked by
        ``_release_client_lease``), its breaker and injected slowness reset.
        Returns the number of generations replayed."""
        with self._flip_lock:
            self._down[node_id] = False
            self._slow[node_id] = 1.0
            node = self.nodes[node_id]
            replayed = 0
            for gen, sub in self._pending_loads[node_id]:
                node.bulk_load(sub, gen)
                replayed += 1
                self.rereplicated_bytes += sum(
                    len(s.blob) for stripes in sub.values() for s in stripes)
            self._pending_loads[node_id] = []
            for lease in self._orphan_leases[node_id]:
                lease.release()
            self._orphan_leases[node_id] = []
            self._breakers[node_id].reset()
            self.rereplications += replayed
            self._gc_placements_locked()
        self._emit("node_recover", node=node_id, replayed=replayed)
        return replayed

    # -- write path -----------------------------------------------------------
    def bulk_load(self, tables, generation: int) -> None:
        """Install a generation on every replica atomically w.r.t. leases.

        Runs under the flip lock (the epoch barrier): once any node sees the
        new generation, every concurrent ``acquire_lease`` sees it on ALL
        reachable nodes. Lease-id reuse is validated client-side BEFORE any
        node installs, so a rejected load never leaves nodes on mixed
        generations. Each (user, group) table lands on the r nodes of the
        user's replica chain; every node receives the load (possibly with an
        empty subset) so generation state stays uniform across the tier. A
        down node's load queues for replay at ``recover()``."""
        with self._flip_lock:
            if generation >= 0 and self._lease_refs.get(generation, 0) > 0:
                raise ValueError(
                    f"generation id {generation} is still leased "
                    f"(refs={self._lease_refs[generation]}); ids must not be "
                    f"reused while leased")
            placement = self._placement_for_load(tables)
            node_tables: List[dict] = [{} for _ in self.nodes]
            for (user_id, group), stripes in tables.items():
                for nid in placement.replicas_of(user_id):
                    node_tables[nid][(user_id, group)] = stripes
            for nid, (node, sub) in enumerate(zip(self.nodes, node_tables)):
                if self._down[nid]:
                    self._pending_loads[nid].append((generation, sub))
                else:
                    node.bulk_load(sub, generation)
            self.generation = generation
            self._placements[generation] = placement
            self._live_placement = placement
            self._rebalance_pending = False
            self._gc_placements_locked()
        self._emit("generation_flip", store="sharded", generation=generation,
                   tables=len(tables))

    def _placement_for_load(self, tables) -> PlacementMap:
        if self.placement_policy == "hash":
            return PlacementMap(self.n_nodes, self.n_shards, {},
                                self.replication_factor)
        if self.generation >= 0 and not self._rebalance_pending:
            # sticky: reuse the live overrides until an explicit rebalance —
            # daily compaction must not migrate users as a side effect
            return PlacementMap(self.n_nodes, self.n_shards,
                                dict(self._live_placement.overrides),
                                self.replication_factor)
        loads: Dict[int, int] = {}
        for (user_id, _group), stripes in tables.items():
            loads[user_id] = loads.get(user_id, 0) + sum(
                len(s.blob) for s in stripes)
        return PlacementMap(
            self.n_nodes, self.n_shards,
            length_aware_overrides(loads, self.n_nodes, self.n_shards,
                                   self.heavy_tail_fraction),
            self.replication_factor)

    def _gc_placements_locked(self) -> None:
        for g in list(self._placements):
            if g == self.generation:
                continue
            if any(node.has_generation(g) for node in self.nodes):
                continue   # still live/retained on some replica
            if any(g == pg for pending in self._pending_loads
                   for pg, _sub in pending):
                continue   # awaiting replay on a down node
            del self._placements[g]

    # -- generation leases -----------------------------------------------------
    def acquire_lease(
        self, generation: Optional[int] = None
    ) -> ShardedGenerationLease:
        """Pin one CONSISTENT generation on every reachable node (epoch
        barrier: the flip lock orders this against ``bulk_load``, so all node
        leases name the same generation). A down node is skipped — its copy
        is settled by ``recover()`` — so pinned scans resolve on the
        survivors. Raises ``GenerationUnavailable`` — with no node lease left
        behind — if the generation is gone."""
        with self._flip_lock:
            node_leases: List[Tuple[int, object]] = []
            try:
                for nid, node in enumerate(self.nodes):
                    if self._down[nid]:
                        continue
                    node_leases.append((nid, node.acquire_lease(generation)))
            except GenerationUnavailable:
                for _nid, lease in node_leases:
                    lease.release()
                raise
            if not node_leases:
                raise NodeUnavailable(
                    "no store node reachable to acquire a generation lease")
            gen = node_leases[0][1].generation
            self._lease_refs[gen] = self._lease_refs.get(gen, 0) + 1
            self._lease_ls.acquired += 1
        self._emit("lease_acquire", store="sharded", generation=gen,
                   nodes=len(node_leases))
        return ShardedGenerationLease(self, gen, node_leases)

    def _release_client_lease(self, generation: int, node_leases) -> None:
        with self._flip_lock:
            for nid, lease in node_leases:
                if self._down[nid]:
                    # the node died while leased: park the release as an
                    # orphan — recover() settles it, so nothing leaks and the
                    # node's retained copy survives until reconciliation
                    self._orphan_leases[nid].append(lease)
                    self._lease_ls.lease_recoveries += 1
                else:
                    lease.release()
            self._lease_ls.released += 1
            refs = self._lease_refs.get(generation, 0) - 1
            if refs <= 0:
                self._lease_refs.pop(generation, None)
            else:
                self._lease_refs[generation] = refs
            self._gc_placements_locked()
        self._emit("lease_release", store="sharded", generation=generation)

    @property
    def lease_stats(self) -> LeaseStats:
        """Logical (client-level) acquire/release counts; retention/GC cycles
        are uniform across nodes, so node 0's counters stand for the tier."""
        n0 = self.nodes[0].lease_stats
        return LeaseStats(
            acquired=self._lease_ls.acquired,
            released=self._lease_ls.released,
            generations_retained=n0.generations_retained,
            generations_gc=n0.generations_gc,
            lease_recoveries=self._lease_ls.lease_recoveries,
        )

    def has_generation(self, generation: int) -> bool:
        # union over replicas: a generation is servable while ANY node still
        # holds it (a recovered node may have dropped a retained generation
        # that survivors still pin — the failover executor routes there)
        return (generation == self.generation
                or any(node.has_generation(generation)
                       for node in self.nodes))

    def leased_generations(self) -> Dict[int, int]:
        """generation -> outstanding LOGICAL lease refcount (one sharded
        lease counts once, not once per node)."""
        with self._flip_lock:
            return dict(self._lease_refs)

    def retained_generations(self) -> List[int]:
        out = set()
        for node in self.nodes:
            out.update(node.retained_generations())
        return sorted(out)

    # -- failover executor -----------------------------------------------------
    # failover-stat fields that double as control-plane timeline events
    # (breaker transitions are emitted by the breakers' own listeners, and
    # hedged_reads is volume, not an incident)
    _COUNT_EVENTS = {"failovers": "failover", "hedge_wins": "hedge_win",
                     "degraded_scans": "degraded_scan",
                     "partial_reissues": "partial_reissue"}

    def _count(self, call: Optional[IOStats], field: str, n: int = 1) -> None:
        with self._stats_lock:
            setattr(self._failover_stats, field,
                    getattr(self._failover_stats, field) + n)
            if call is not None:
                setattr(call, field, getattr(call, field) + n)
        kind = self._COUNT_EVENTS.get(field)
        if kind is not None:
            self._emit(kind)

    def _timed_op(self, op: Callable[[int], object], rep: int):
        """One attempt against one node: down check, injected slowness, and
        the round-trip feeds the tier latency tracker (the hedge trigger)."""
        if self._down[rep]:
            raise NodeUnavailable(f"store node {rep} is down")
        t0 = time.perf_counter()
        out = op(rep)
        elapsed = time.perf_counter() - t0
        mult = self._slow[rep]
        if mult > 1.0:
            extra = (mult - 1.0) * max(elapsed, 1e-3)
            time.sleep(extra)
            elapsed += extra
        self._latency.record(elapsed)
        return out

    def _hedge_deadline(self) -> Optional[float]:
        if not self.hedge_quantile:
            return None
        return self._latency.quantile(self.hedge_quantile)

    def _attempt(self, rep: int, chain: Sequence[int],
                 op: Callable[[int], object], call: Optional[IOStats]):
        """One (possibly hedged) attempt. With hedging armed, the primary
        runs with a deadline at the tier's latency quantile; past it, the
        same op fires at the next live replica and the first success wins.
        The loser's result is discarded — its physical I/O still lands in
        that node's own counters, which is the truth: hedges burn real I/O
        to buy tail latency."""
        deadline = self._hedge_deadline() if len(chain) > 1 else None
        hedge_to = None
        if deadline is not None:
            hedge_to = next((c for c in chain
                             if c != rep and not self._down[c]), None)
        if hedge_to is None:
            return self._timed_op(op, rep)
        primary_f = self._hedge_pool.submit(self._timed_op, op, rep)
        try:
            return primary_f.result(timeout=deadline)
        except FutureTimeout:
            pass   # slow, not failed: hedge it
        self._count(call, "hedged_reads")
        hedge_f = self._hedge_pool.submit(self._timed_op, op, hedge_to)
        pending = {primary_f, hedge_f}
        while pending:
            done, _ = futures_wait(pending, return_when=FIRST_COMPLETED)
            pending -= done
            for f in (primary_f, hedge_f):   # prefer the primary on a tie
                if f in done and f.exception() is None:
                    if f is hedge_f:
                        self._count(call, "hedge_wins")
                        self._breakers[hedge_to].record_success()
                    return f.result()
        raise primary_f.exception()

    def _with_failover(self, primary: int, chain: Sequence[int],
                       op: Callable[[int], object],
                       call: Optional[IOStats] = None,
                       reissue_siblings: bool = False):
        """Run ``op`` against the replica chain with health-aware retries.

        Walks the chain skipping breaker-open nodes; an I/O failure records
        on the node's breaker and falls over to the next replica
        (``failovers``). A fully-failed pass re-issues after seeded
        deterministic backoff, up to ``max_group_retries`` times — when the
        caller has sibling groups whose results are being retained, each
        re-issue counts as a ``partial_reissue``. ``GenerationUnavailable``
        never trips a breaker (the node is healthy, the data is gone) but
        the next replica is still consulted: a survivor may retain the
        generation. Exhausting the chain raises ``NodeUnavailable``
        (``degraded_scans``) if any failure was I/O, else propagates the
        data-gone error."""
        last_io: Optional[Exception] = None
        last_gen: Optional[GenerationUnavailable] = None
        for rnd in range(self.max_group_retries + 1):
            if rnd:
                if last_io is None:
                    break   # pure data-gone: retrying cannot help
                if reissue_siblings:
                    self._count(call, "partial_reissues")
                self._backoff.sleep(rnd - 1, token=primary + 1)
            attempted = False
            for rep in chain:
                breaker = self._breakers[rep]
                if not breaker.allow():
                    continue
                attempted = True
                try:
                    out = self._attempt(rep, chain, op, call)
                except GenerationUnavailable as exc:
                    last_gen = exc
                    continue
                except (NodeUnavailable, IOError) as exc:
                    if breaker.record_failure():
                        self._count(call, "breaker_opens")
                    last_io = exc
                    continue
                breaker.record_success()
                if rep != primary:
                    self._count(call, "failovers")
                return out
            if not attempted and last_io is None:
                # every breaker in the chain is open from prior calls — the
                # outage predates this read; classify it as I/O so the retry
                # rounds (whose backoff outlives breaker reset) get a probe
                last_io = NodeUnavailable(
                    f"all replica breakers open for node group {primary} "
                    f"(chain {tuple(chain)})")
        if last_io is not None:
            self._count(call, "degraded_scans")
            raise NodeUnavailable(
                f"all {len(chain)} replica(s) of node group {primary} "
                f"unavailable (chain {tuple(chain)})") from last_io
        assert last_gen is not None
        raise last_gen

    def _group_chain(self, nid: int, reqs: Sequence[ScanRequest]
                     ) -> Tuple[int, ...]:
        """Replica chain for a node group. Requests in a group share their
        primary, and replicas are uniform offsets from it, so the group
        chain is the user chain; a group mixing generations loaded at
        different replication factors uses the smallest (a replica that one
        generation never loaded to must not serve the group)."""
        gens = {q.generation for q in reqs}
        r = min((max(1, min(self.placement_for(g).replication_factor,
                            self.n_nodes)) for g in gens), default=1)
        return tuple((nid + k) % self.n_nodes for k in range(r))

    # -- read path -------------------------------------------------------------
    def _effective_traits(self, req: ScanRequest) -> Tuple[str, ...]:
        return req.traits or self.schema.group_traits(req.group)

    def scan(self, req: ScanRequest) -> ev.EventBatch:
        chain = self.placement_for(req.generation).replicas_of(req.user_id)
        return self._with_failover(
            chain[0], chain, lambda rep: self.nodes[rep].scan(req), IOStats())

    def estimate_scan(self, req: ScanRequest) -> Tuple[int, int]:
        """Metadata-only cost walk (see the monolith): routed like the scan
        would be, but served even from a down node — estimates are control
        plane, not data I/O."""
        return self._node_for(req.user_id, req.generation).estimate_scan(req)

    def plan(self, reqs: Sequence[ScanRequest]) -> ScanPlan:
        """Client-side planning: dedupe + union-projection subsumption over
        the whole batch (a request answered by an in-plan twin or carved from
        a wider root never crosses the network at all), roots grouped by
        TARGET NODE — ``ScanPlan.shard_groups`` keys are node ids here."""
        return build_scan_plan(
            reqs,
            lambda r: self._node_of(r.user_id, r.generation),
            self._effective_traits)

    def execute_plan(
        self, plan: ScanPlan, out_stats: Optional[IOStats] = None
    ) -> List[ev.EventBatch]:
        """Execute node groups concurrently: ONE batched round-trip per node
        group (the node replans its slice over its local shards and
        parallelizes there), subsumed requests carved client-side from the
        covering results. Each group runs under the failover executor, so a
        failed group re-routes to its replicas and re-issues with backoff
        WITHOUT touching its completed siblings; only if a group exhausts its
        whole chain does the call raise (``NodeUnavailable``, retryable) —
        and then no partial result is returned. Results return in original
        request order."""
        results: List[Optional[ev.EventBatch]] = [None] * len(plan.unique)
        call = IOStats()
        groups = list(plan.shard_groups.items())
        many = len(groups) > 1

        def run_group(pair) -> IOStats:
            nid, idxs = pair
            reqs = [plan.unique[j] for j in idxs]
            chain = self._group_chain(nid, reqs)

            def op(rep: int):
                # fresh stats per attempt: a failed or losing attempt must
                # not leak its partial I/O into the call's delta (the node's
                # own cumulative counters still record it — physical truth)
                local = IOStats()
                parts = self.nodes[rep].multi_range_scan(reqs, local)
                return parts, local

            parts, local = self._with_failover(nid, chain, op, call,
                                               reissue_siblings=many)
            for j, part in zip(idxs, parts):
                results[j] = part
            return local

        if not many:
            node_locals = [run_group(g) for g in groups]
        else:
            futures = [self._pool.submit(run_group, g) for g in groups]
            node_locals = []
            first_exc: Optional[BaseException] = None
            for f in futures:
                try:
                    node_locals.append(f.result())
                except BaseException as exc:   # noqa: BLE001 — re-raised below
                    if first_exc is None:
                        first_exc = exc
            if first_exc is not None:
                # no partial results: completed siblings were retained for
                # the in-plan re-issues, but the CALL fails whole
                raise first_exc
        for j, k in plan.derived.items():
            results[j] = ev.tail_view(results[k], plan.unique[j].max_events,
                                      self._effective_traits(plan.unique[j]))
        for local in node_locals:
            call.merge(local)
        # plan-level counters are the CLIENT's: nodes each count their own
        # round-trip, and dedupe/subsumption already happened up here
        call.batched_requests = 1
        call.dedup_hits = plan.dedup_hits
        call.subsumed_hits = plan.subsumed
        with self._stats_lock:
            self._client_plan_stats.batched_requests += 1
            self._client_plan_stats.dedup_hits += plan.dedup_hits
            self._client_plan_stats.subsumed_hits += plan.subsumed
        if out_stats is not None:
            out_stats.merge(call)
        return [results[j] for j in plan.assignment]

    def multi_range_scan(
        self,
        reqs: Sequence[ScanRequest],
        out_stats: Optional[IOStats] = None,
    ) -> List[ev.EventBatch]:
        return self.execute_plan(self.plan(reqs), out_stats)

    # -- stats + introspection -------------------------------------------------
    @property
    def stats(self) -> IOStats:
        """Tier-wide view: physical I/O summed over nodes (including the
        losing half of hedged reads — that I/O really happened), plan-level
        counters (batched_requests / dedup_hits / subsumed_hits) from the
        client planner, health counters (failovers / hedged_reads /
        hedge_wins / breaker_opens / degraded_scans / partial_reissues) from
        the failover executor. ``parallel_shards`` sums the nodes' local
        shard fanout — the tier's real physical scan parallelism."""
        agg = IOStats()
        for node in self.nodes:
            agg.merge(node.stats)
        with self._stats_lock:
            agg.merge(self._failover_stats)
            agg.batched_requests = self._client_plan_stats.batched_requests
            agg.dedup_hits = self._client_plan_stats.dedup_hits
            agg.subsumed_hits = self._client_plan_stats.subsumed_hits
        return agg

    def node_stats(self) -> NodeStats:
        per_node = [node.stats.snapshot() for node in self.nodes]
        scan_load = [s.bytes_scanned for s in per_node]
        stored = [node.stored_bytes() for node in self.nodes]
        return NodeStats(
            per_node=per_node,
            scan_load=scan_load,
            seeks=[s.seeks for s in per_node],
            decodes=[s.stripes_read for s in per_node],
            stored=stored,
            max_mean_load_ratio=NodeStats._ratio(scan_load),
            max_mean_stored_ratio=NodeStats._ratio(stored),
            down=list(self._down),
            breaker=[b.state for b in self._breakers],
            breaker_opens=[b.opens for b in self._breakers],
            pending_replays=[len(p) for p in self._pending_loads],
        )

    @property
    def latency_model(self):
        return self.nodes[0].latency_model

    @latency_model.setter
    def latency_model(self, model) -> None:
        # each node charges its own remote-I/O latency; node groups overlap
        # on the client pool, so a batch's wall time is the max over nodes
        for node in self.nodes:
            node.latency_model = model

    @property
    def bulk_load_bytes(self) -> int:
        return sum(node.bulk_load_bytes for node in self.nodes)

    def stored_bytes(self) -> int:
        return sum(node.stored_bytes() for node in self.nodes)

    def retained_bytes(self) -> int:
        return sum(node.retained_bytes() for node in self.nodes)

    def stored_events(self, user_id: int, group: str) -> int:
        return self._node_for(user_id).stored_events(user_id, group)

    def watermark(self, user_id: int, group: str = "core",
                  generation: int = -1) -> int:
        return self._node_for(user_id, generation).watermark(
            user_id, group, generation)

    def fanout(self, reqs: Sequence[ScanRequest]) -> int:
        """Distinct NODES a batch touches (the cross-network fanout the
        affinity planner minimizes)."""
        return len({self._node_of(r.user_id, r.generation) for r in reqs})

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        self._hedge_pool.shutdown(wait=True)
        for node in self.nodes:
            node.close()

    def __enter__(self) -> "ShardedUIHStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
