"""Read-optimized immutable UIH store (paper §4.1.2).

Single-level layout: each user's long-term history is partitioned into
fixed-length temporal *stripes* keyed by the multi-dimensional composite key
``(user_id, feature_group, subsequence_start_ts)``. Stripes are produced
pre-sorted by the offloaded compaction pipeline and **bulk-loaded** as a whole
generation — there is no write path other than ``bulk_load``, hence no LSM
multi-level read amplification and no compaction-induced write amplification.

The read path is a bounded *multi-range scan*: for each request the store
locates the stripe run overlapping ``[start_ts, end_ts]`` (one "seek") and then
reads stripes sequentially. Projection pushdown happens server-side in three
dimensions (§4.1.2):

  1. sequence-length projection — scan only as many stripes (from the most
     recent backwards) as needed for the tenant's ``max_events``;
  2. feature-group projection — the composite key isolates groups physically;
  3. trait projection — selective byte-level decoding inside a stripe.

Batched reads are *planned* (§4.2.3, "optimized multi-range scan with parallel
I/O"). ``plan()`` dedupes identical ``(user_id, group, bounds, max_events,
traits)`` requests and groups the survivors by shard; ``execute_plan()`` then
runs the shard groups concurrently on a thread pool, charging the
``latency_model`` once per shard (parallel remote I/O) instead of once for the
whole batch, and decoding each stripe blob at most once per batch via the
``columnar.StripeDecodeCache`` LRU. ``IOStats`` exposes the plan's work
savings: ``dedup_hits`` (requests answered by an identical in-batch twin),
``decode_cache_hits`` (stripe decodes skipped), and ``parallel_shards``
(cumulative shard fanout executed concurrently by batched scans).

**Generation leases** (bifurcated O2O protocol, §3.2): streaming training has
examples in flight that reference the generation observed at T_request; daily
compaction must not yank that generation out from under them. A publisher
acquires a refcounted ``GenerationLease`` per in-flight example; ``bulk_load``
then *retains* a superseded generation while leases on it remain, and a
``ScanRequest`` carrying ``generation >= 0`` is served from the retained
table — the exact event set the ranking model saw, even if the new generation
scrubbed or re-cut history. Once the last lease is released (the example has
been materialized/trained) the retained generation is garbage-collected.
Scanning a generation that is neither live nor retained raises
``GenerationUnavailable``; the ``Materializer`` remediates by re-resolving
against the live generation with the version's ``end_ts`` clamp plus checksum
revalidation.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import events as ev
from repro_torch.storage import columnar
from repro_torch.storage.sharding import ShardRouter


@dataclasses.dataclass(frozen=True)
class Stripe:
    start_ts: int
    end_ts: int
    n_events: int
    blob: bytes


@dataclasses.dataclass(frozen=True)
class ScanRequest:
    user_id: int
    group: str
    start_ts: int            # inclusive temporal lower bound (version metadata)
    end_ts: int              # inclusive temporal upper bound (version metadata)
    max_events: int = -1     # sequence-length projection (-1 = unbounded)
    traits: Optional[Tuple[str, ...]] = None  # trait projection (None = group's all)
    generation: int = -1     # -1 = live; >= 0 = pinned (leased) generation

    def __post_init__(self):
        """Validate at the API boundary, not deep inside ``_scan_into``.

        ``start_ts > end_ts`` is NOT rejected: inverted bounds are a
        legitimate empty-window request the snapshotter produces routinely —
        a negative ``end_ts`` is the "nothing consolidated yet" watermark
        (examples logged before the first compaction), and a user returning
        after idling longer than the lookback window yields
        ``end_ts = min(watermark, request_ts) < start_ts``. Both scan empty."""
        if self.max_events < -1:
            raise ValueError(
                f"max_events must be >= -1 (-1 = unbounded), got {self.max_events}")
        if self.generation < -1:
            raise ValueError(
                f"generation must be >= -1 (-1 = live), got {self.generation}")


class GenerationUnavailable(KeyError):
    """The requested generation is neither live nor retained by a lease."""


class GenerationLease:
    """Refcounted pin on one immutable generation (context-manager friendly).

    ``release()`` is idempotent; dropping the last lease on a superseded
    generation garbage-collects its tables."""

    __slots__ = ("generation", "_store", "_released")

    def __init__(self, store: "ImmutableUIHStore", generation: int):
        self.generation = generation
        self._store = store
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._store._release_lease(self.generation)

    def __enter__(self) -> "GenerationLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


@dataclasses.dataclass
class LeaseStats:
    acquired: int = 0
    released: int = 0
    generations_retained: int = 0   # superseded generations kept for leases
    generations_gc: int = 0         # retained generations dropped at last release
    lease_recoveries: int = 0       # node leases reconciled after a node death
    #                                 (release fanned in while the node was
    #                                 down; settled by ``recover()``)


@dataclasses.dataclass
class _GenTable:
    """One bulk-loaded generation: shard tables + lease refcount."""

    gen: int
    shards: List[Dict[Tuple[int, str], Tuple[List[int], List["Stripe"]]]]
    refs: int = 0


@dataclasses.dataclass
class IOStats:
    seeks: int = 0
    stripes_read: int = 0
    bytes_scanned: int = 0    # stripe blob bytes touched (I/O)
    bytes_decoded: int = 0    # payload bytes actually decoded (selective decode)
    requests: int = 0         # scans actually executed (post-dedupe)
    batched_requests: int = 0
    dedup_hits: int = 0         # requests answered by an identical in-plan twin
    decode_cache_hits: int = 0  # stripe decodes served from the decode LRU
    parallel_shards: int = 0    # cumulative shard fanout of batched executions
    pinned_scans: int = 0       # scans served from a retained (leased) generation
    subsumed_hits: int = 0      # requests carved from a wider in-plan request
    #                             (union-projection planning, §2.3/§4.2.2)
    # -- replicated-tier health counters (sharded client only, DESIGN.md §12) --
    failovers: int = 0          # reads re-routed off their primary to a replica
    hedged_reads: int = 0       # speculative replica reads fired on a slow node
    hedge_wins: int = 0         # hedges that beat the primary round-trip
    breaker_opens: int = 0      # circuit-breaker CLOSED/HALF_OPEN -> OPEN flips
    degraded_scans: int = 0     # reads that failed on EVERY replica (retryable)
    partial_reissues: int = 0   # failed node groups re-issued while completed
    #                             sibling groups of the same plan were retained

    def snapshot(self) -> "IOStats":
        return dataclasses.replace(self)

    def delta(self, since: "IOStats") -> "IOStats":
        return IOStats(*(getattr(self, f.name) - getattr(since, f.name)
                         for f in dataclasses.fields(IOStats)))

    def merge(self, other: "IOStats") -> None:
        for f in dataclasses.fields(IOStats):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass
class ScanPlan:
    """Deduped, shard-grouped execution plan for a batch of scan requests.

    **Union-projection planning** (§2.3, §4.2.2): beyond exact-duplicate
    dedupe, a request whose (user, group, bounds, generation) matches a wider
    in-plan request with a superset of traits and an equal-or-larger
    ``max_events`` budget never hits storage — it is *derived* by carving the
    wider result (tail-slice to the narrower sequence budget + trait
    projection). ``shard_groups`` only dispatches the covering requests;
    ``derived`` maps each subsumed unique index to its covering unique index.

    The grouping key is the executor's concurrency domain: the monolith keys
    by shard, the disaggregated ``ShardedUIHStore`` keys by store node.
    """

    unique: List[ScanRequest]          # deduped requests, first-seen order
    assignment: List[int]              # original request idx -> unique idx
    shard_groups: Dict[int, List[int]]  # shard/node -> indices into ``unique``
    derived: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def dedup_hits(self) -> int:
        return len(self.assignment) - len(self.unique)

    @property
    def subsumed(self) -> int:
        return len(self.derived)

    @property
    def fanout(self) -> int:
        return len(self.shard_groups)


def build_scan_plan(reqs, route, effective_traits) -> ScanPlan:
    """Shared planner behind every store implementation's ``plan()``:
    dedupe identical requests, subsume projection-contained ones
    (union-projection planning), group the surviving roots by ``route(req)``
    — the executor's concurrency domain (shard for the monolith, node for
    the sharded client).

    ``effective_traits(req)`` resolves a request's trait set (None = the
    group's full schema) so subsumption compares real column sets."""
    index: Dict[ScanRequest, int] = {}
    unique: List[ScanRequest] = []
    assignment: List[int] = []
    by_window: Dict[tuple, List[int]] = {}
    for r in reqs:
        j = index.get(r)
        if j is None:
            j = index[r] = len(unique)
            unique.append(r)
            by_window.setdefault(
                (r.user_id, r.group, r.start_ts, r.end_ts, r.generation),
                []).append(j)
        assignment.append(j)

    derived: Dict[int, int] = {}
    inf = float("inf")
    for js in by_window.values():
        if len(js) < 2:
            continue
        info = {
            j: (unique[j].max_events if unique[j].max_events >= 0 else inf,
                frozenset(effective_traits(unique[j])))
            for j in js
        }
        # widest first: a later (narrower) request can only be covered by
        # an already-accepted root
        roots: List[int] = []
        for j in sorted(js, key=lambda j: (info[j][0], len(info[j][1])),
                        reverse=True):
            me_j, tr_j = info[j]
            cover = next(
                (k for k in roots
                 if info[k][0] >= me_j and info[k][1] >= tr_j), None)
            if cover is None:
                roots.append(j)
            else:
                derived[j] = cover

    shard_groups: Dict[int, List[int]] = {}
    for j, r in enumerate(unique):
        if j in derived:
            continue
        shard_groups.setdefault(route(r), []).append(j)
    return ScanPlan(unique=unique, assignment=assignment,
                    shard_groups=shard_groups, derived=derived)


class ImmutableUIHStore:
    # Optional per-run telemetry (repro_torch.obs.Telemetry) attached by
    # ``open_feed``; every hook below degrades to one is-None check.
    # Sharded tiers attach to the tier object only — member StoreNodes stay
    # untelemetered so flips/leases are not double-counted.
    telemetry = None

    def __init__(
        self,
        schema: Optional[ev.TraitSchema] = None,
        n_shards: int = 8,
        decode_cache_size: int = 256,
    ):
        self.schema = schema or ev.default_schema()
        self.router = ShardRouter(n_shards)
        self.n_shards = n_shards
        # live generation: shard -> (user_id, group) -> (start_ts list, stripes)
        self._live = _GenTable(gen=-1, shards=[{} for _ in range(n_shards)])
        # superseded generations pinned by outstanding leases (gen -> table)
        self._retained: Dict[int, _GenTable] = {}
        self._gen_lock = threading.Lock()
        self.lease_stats = LeaseStats()
        self.generation = -1
        self.stats = IOStats()
        self.bulk_load_bytes = 0
        # Optional remote-I/O latency emulation for DPP benchmarks:
        # callable(seeks, bytes_scanned, shard_fanout) -> seconds to sleep.
        # Batched execution charges it once per shard group (parallel I/O).
        self.latency_model = None
        self.decode_cache = (
            columnar.StripeDecodeCache(decode_cache_size)
            if decode_cache_size > 0 else None
        )
        self._stats_lock = threading.Lock()
        # eager: an idle executor spawns no threads until first submit, and
        # eager construction avoids double-create races on first batched scan
        self._pool = ThreadPoolExecutor(
            max_workers=min(n_shards, 16), thread_name_prefix="uih-scan"
        )

    # -- compat: the live generation's shard tables --------------------------
    @property
    def _shards(self) -> List[Dict[Tuple[int, str], Tuple[List[int], List[Stripe]]]]:
        return self._live.shards

    # -- bulk load (write path) ---------------------------------------------
    def bulk_load(
        self,
        tables: Dict[Tuple[int, str], List[Stripe]],
        generation: int,
    ) -> None:
        """Install a new compaction generation as the live read target.

        ``tables`` maps (user_id, group) -> chronologically ordered stripes.
        Pre-sorted input is *required* (compaction guarantees it); the store
        only verifies and installs — mirroring a bulk file ingest.

        The superseded generation is dropped immediately UNLESS leases pin it
        (in-flight streaming examples still reference it) — then it is
        retained until the last lease is released. In-flight scans are safe
        either way: they resolve their shard tables once, up front."""
        new_shards: List[Dict[Tuple[int, str], Tuple[List[int], List[Stripe]]]] = [
            {} for _ in range(self.n_shards)
        ]
        load_bytes = 0
        for (user_id, group), stripes in tables.items():
            starts = [s.start_ts for s in stripes]
            assert starts == sorted(starts), "compaction must emit sorted stripes"
            shard = self.router.route(user_id)
            new_shards[shard][(user_id, group)] = (starts, list(stripes))
            load_bytes += sum(len(s.blob) for s in stripes)
        with self._gen_lock:
            old = self._live
            if generation in self._retained or (
                    old.gen == generation and old.gen >= 0 and old.refs > 0):
                # a leased generation's bytes must never change: silently
                # replacing its tables would swap content under leaseholders
                # (and strand their refcounts on the new table)
                refs = (self._retained[generation].refs
                        if generation in self._retained else old.refs)
                raise ValueError(
                    f"generation id {generation} is still leased "
                    f"(refs={refs}); ids must not be reused while leased")
            if old.refs > 0 and old.gen >= 0 and old.gen != generation:
                self._retained[old.gen] = old
                self.lease_stats.generations_retained += 1
            self._live = _GenTable(gen=generation, shards=new_shards)
            self.generation = generation
        self.bulk_load_bytes += load_bytes
        self._emit("generation_flip", store="immutable",
                   generation=generation, tables=len(tables))

    def _emit(self, kind: str, **fields) -> None:
        tel = self.telemetry
        if tel is not None:
            tel.events.emit(kind, **fields)

    def publish_telemetry(self) -> None:
        """Flush the store's cumulative counters into the attached telemetry
        registry (idempotent; adapters take monotone maxima)."""
        tel = self.telemetry
        if tel is None:
            return
        tel.publish_stats(self.stats, "io", store="immutable")
        tel.publish_stats(self.lease_stats, "lease", store="immutable")

    # -- generation leases ----------------------------------------------------
    def acquire_lease(self, generation: Optional[int] = None) -> GenerationLease:
        """Pin ``generation`` (default: live) against GC by future bulk loads.

        Raises ``GenerationUnavailable`` if the generation has already been
        superseded AND garbage-collected."""
        with self._gen_lock:
            live = self._live
            if generation is None or generation < 0 or generation == live.gen:
                live.refs += 1
                target = live.gen
            else:
                g = self._retained.get(generation)
                if g is None:
                    raise GenerationUnavailable(
                        f"generation {generation} is gone (live={live.gen}, "
                        f"retained={sorted(self._retained)})")
                g.refs += 1
                target = generation
            self.lease_stats.acquired += 1
        self._emit("lease_acquire", store="immutable", generation=target)
        return GenerationLease(self, target)

    def _release_lease(self, generation: int) -> None:
        with self._gen_lock:
            self.lease_stats.released += 1
            if generation == self._live.gen:
                self._live.refs = max(0, self._live.refs - 1)
            else:
                g = self._retained.get(generation)
                if g is not None:
                    g.refs -= 1
                    if g.refs <= 0:
                        del self._retained[generation]
                        self.lease_stats.generations_gc += 1
        self._emit("lease_release", store="immutable", generation=generation)

    def has_generation(self, generation: int) -> bool:
        """True iff a ``ScanRequest(generation=...)`` would be servable now."""
        return generation == self._live.gen or generation in self._retained

    def leased_generations(self) -> Dict[int, int]:
        """generation -> outstanding lease refcount (live included if leased)."""
        with self._gen_lock:
            out = {g.gen: g.refs for g in self._retained.values()}
            if self._live.refs > 0:
                out[self._live.gen] = self._live.refs
            return out

    def retained_generations(self) -> List[int]:
        with self._gen_lock:
            return sorted(self._retained)

    # -- read path ------------------------------------------------------------
    def _table_for(self, generation: int):
        """Shard tables serving ``generation`` (-1 = live). Lock-free: a single
        attribute/dict read suffices, and holding the returned reference keeps
        the tables alive even if the generation is GC'd mid-scan."""
        live = self._live
        if generation < 0 or generation == live.gen:
            return live.shards
        g = self._retained.get(generation)
        if g is not None:
            return g.shards
        raise GenerationUnavailable(
            f"generation {generation} is gone (live={live.gen})")

    def _locate(self, user_id: int, group: str, generation: int = -1):
        shard = self.router.route(user_id)
        return shard, self._table_for(generation)[shard].get((user_id, group))

    def _decode(self, s: Stripe, traits, stats: IOStats) -> ev.EventBatch:
        if self.decode_cache is None:
            stats.bytes_decoded += columnar.decoded_bytes_for(s.blob, traits)
            return columnar.decode_stripe(s.blob, self.schema, traits)
        batch, hit = self.decode_cache.get(s.blob, self.schema, traits)
        if hit:
            stats.decode_cache_hits += 1
        else:
            stats.bytes_decoded += columnar.decoded_bytes_for(s.blob, traits)
        return batch

    def _select_stripes(self, req: ScanRequest, entry) -> List[Stripe]:
        """The stripe run a request reads: overlap [start_ts, end_ts], walked
        backwards from the most recent stripe until the sequence-length budget
        is met (shared by the scan itself and ``estimate_scan``)."""
        starts, stripes = entry
        lo = bisect.bisect_right(starts, req.start_ts) - 1
        lo = max(lo, 0)
        hi = bisect.bisect_right(starts, req.end_ts)  # stripes[lo:hi] may overlap
        if lo >= hi:
            return []
        chosen: List[Stripe] = []
        have = 0
        for i in range(hi - 1, lo - 1, -1):
            s = stripes[i]
            if s.end_ts < req.start_ts:
                break
            chosen.append(s)
            # conservative count: events in stripe within bound (upper estimate)
            have += s.n_events
            if req.max_events >= 0 and have >= req.max_events + s.n_events:
                # we may overshoot by up to one stripe at each temporal edge;
                # an extra stripe guards against end_ts trimming removing events
                break
        chosen.reverse()
        return chosen

    def estimate_scan(self, req: ScanRequest) -> Tuple[int, int]:
        """Metadata-only cost of one scan: ``(stripes, blob_bytes)`` the
        request would read right now. Walks the same stripe-selection logic as
        the scan itself — the estimate matches ``IOStats.stripes_read`` /
        ``bytes_scanned`` exactly — but touches no blobs: no decode, no
        latency charge, no stats. Raises ``GenerationUnavailable`` like a real
        scan would (callers doing best-effort accounting should catch it)."""
        _, entry = self._locate(req.user_id, req.group, req.generation)
        if entry is None:
            return 0, 0
        chosen = self._select_stripes(req, entry)
        return len(chosen), sum(len(s.blob) for s in chosen)

    def _scan_into(self, req: ScanRequest, stats: IOStats) -> ev.EventBatch:
        """Execute one range scan, accounting I/O into ``stats`` (the batched
        executor passes per-shard accumulators so shard threads don't race)."""
        stats.requests += 1
        traits = req.traits or self.schema.group_traits(req.group)
        if req.generation >= 0 and req.generation != self.generation:
            stats.pinned_scans += 1
        shard, entry = self._locate(req.user_id, req.group, req.generation)
        if entry is None:
            return ev.empty_batch(self.schema, traits)
        stats.seeks += 1  # single-level layout: one seek per (user,group) run
        chosen = self._select_stripes(req, entry)
        if not chosen:
            return ev.empty_batch(self.schema, traits)

        parts: List[ev.EventBatch] = []
        for s in chosen:
            stats.stripes_read += 1
            stats.bytes_scanned += len(s.blob)
            parts.append(self._decode(s, traits, stats))
        out = ev.concat_batches(parts)
        if not out:
            return ev.empty_batch(self.schema, traits)
        out = ev.time_slice(out, req.start_ts, req.end_ts)
        # keep the most recent max_events (tenant sequence-length budget)
        return ev.tail_view(out, req.max_events)

    def scan(self, req: ScanRequest) -> ev.EventBatch:
        """Bounded range scan with 3-dimensional projection pushdown."""
        return self._scan_into(req, self.stats)

    # -- planned batch execution ----------------------------------------------
    def _effective_traits(self, req: ScanRequest) -> Tuple[str, ...]:
        return req.traits or self.schema.group_traits(req.group)

    def plan(self, reqs: Sequence[ScanRequest]) -> ScanPlan:
        """Dedupe identical requests, subsume projection-contained ones, and
        group the surviving root requests by shard.

        Subsumption (union-projection planning): among requests sharing
        (user, group, bounds, generation), one whose traits are a subset and
        whose ``max_events`` budget is no larger than another's is marked
        *derived* — the executor serves it by carving the wider result instead
        of scanning (``IOStats.subsumed_hits``). This is what lets N tenant
        projections over the same window cost ONE storage scan."""
        return build_scan_plan(
            reqs, lambda r: self.router.route(r.user_id),
            self._effective_traits)

    def _carve(self, req: ScanRequest, wide: ev.EventBatch) -> ev.EventBatch:
        """Serve a subsumed request from its covering request's result:
        tail-slice to the narrower sequence budget, project to the narrower
        traits — byte-identical to executing the narrow scan directly (same
        bounds => the wide result's most-recent tail IS the narrow event
        set; trait decode is column-independent)."""
        return ev.tail_view(wide, req.max_events, self._effective_traits(req))

    def close(self) -> None:
        """Shut down the shard-scan thread pool (idempotent). Long-lived
        processes that churn through stores should close them (or use the
        store as a context manager); short-lived ones can rely on interpreter
        exit — an unused pool never spawns threads."""
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "ImmutableUIHStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def execute_plan(
        self, plan: ScanPlan, out_stats: Optional[IOStats] = None
    ) -> List[ev.EventBatch]:
        """Run a plan's shard groups concurrently; results in original request
        order (deduped requests share one execution).

        ``out_stats``: optional caller-owned accumulator that receives this
        call's delta as well — the global ``self.stats`` is shared across all
        callers, so a concurrent caller cannot attribute snapshot/delta
        windows of it to its own traffic."""
        results: List[Optional[ev.EventBatch]] = [None] * len(plan.unique)

        def run_shard(group: List[int]) -> IOStats:
            local = IOStats()
            for j in group:
                results[j] = self._scan_into(plan.unique[j], local)
            if self.latency_model is not None:
                # each shard pays its own I/O latency (plus the batch's
                # cross-shard coordination term); shards overlap, so the
                # batch's wall time is the max over shards, not the sum
                delay = self.latency_model(local.seeks, local.bytes_scanned,
                                           plan.fanout)
                if delay > 0:
                    time.sleep(delay)
            return local

        groups = list(plan.shard_groups.values())
        if len(groups) <= 1:
            shard_stats = [run_shard(g) for g in groups]
        else:
            shard_stats = list(self._pool.map(run_shard, groups))
        # subsumed requests: carve the narrower view out of the covering
        # result — no storage I/O, no decode (union-projection planning)
        for j, k in plan.derived.items():
            results[j] = self._carve(plan.unique[j], results[k])
        call = IOStats(batched_requests=1, dedup_hits=plan.dedup_hits,
                       parallel_shards=plan.fanout,
                       subsumed_hits=plan.subsumed)
        for local in shard_stats:
            call.merge(local)
        with self._stats_lock:
            self.stats.merge(call)
        if out_stats is not None:
            out_stats.merge(call)
        return [results[j] for j in plan.assignment]

    def multi_range_scan(
        self,
        reqs: Sequence[ScanRequest],
        out_stats: Optional[IOStats] = None,
    ) -> List[ev.EventBatch]:
        """Batched scan (paper: 'optimized multi-range scan with parallel I/O'):
        plans (dedupe + shard grouping), then executes shards concurrently —
        see ``plan()`` / ``execute_plan()``."""
        return self.execute_plan(self.plan(reqs), out_stats)

    # -- introspection ---------------------------------------------------------
    def live_placement(self):
        """User -> node placement of the live generation. The monolith has no
        node topology — every consumer treating ``None`` as "single node"
        (e.g. ``plan_affine``) behaves exactly as before disaggregation."""
        return None

    def fanout(self, reqs: Sequence[ScanRequest]) -> int:
        return len({self.router.route(r.user_id) for r in reqs})

    def stored_bytes(self) -> int:
        return sum(
            len(s.blob)
            for shard in self._shards
            for _, stripes in shard.values()
            for s in stripes
        )

    def retained_bytes(self) -> int:
        """Extra bytes held alive by generation leases (retention cost)."""
        with self._gen_lock:
            gens = list(self._retained.values())
        return sum(
            len(s.blob)
            for g in gens
            for shard in g.shards
            for _, stripes in shard.values()
            for s in stripes
        )

    def stored_events(self, user_id: int, group: str) -> int:
        _, entry = self._locate(user_id, group)
        if entry is None:
            return 0
        return sum(s.n_events for s in entry[1])

    def watermark(self, user_id: int, group: str = "core",
                  generation: int = -1) -> int:
        """Largest timestamp consolidated into the immutable tier for a user
        (as of ``generation``; -1 = live)."""
        _, entry = self._locate(user_id, group, generation)
        if entry is None or not entry[1]:
            return -1
        return entry[1][-1].end_ts
