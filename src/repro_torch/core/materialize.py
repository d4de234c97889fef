"""Training-time versioned late materialization ("Time-Travel", paper §3.3).

Given a logged training example, the materializer:
  1. extracts the version metadata + the snapshotted mutable slice;
  2. issues a bounded multi-range scan against the immutable store using the
     logged temporal boundaries, with the tenant's projection pushed down
     (sequence-length / feature-group / trait);
  3. concatenates immutable + mutable components into the complete UIH that
     exactly reproduces the inference-time state;
  4. optionally validates the checksum logged at inference time.

The logic depends only on the logged metadata, never on the training paradigm,
so streaming and batch training share it unchanged (§3.2).

**Stale-generation remediation** (bifurcated protocol, §3.2): an example may
reference an immutable generation that daily compaction has since superseded.
Resolution is layered:

  1. *pinned* (``pin_generations=True``, the streaming path): if the example's
     generation is still retained by a ``GenerationLease``, scan it directly —
     byte-exact reproduction even if the new generation scrubbed history;
  2. *re-resolve*: otherwise scan the LIVE generation with the version's
     ``end_ts`` clamp (compaction rebuilds the full lookback window, so the
     clamped scan reproduces the window and can never admit post-request
     events) and **revalidate the checksum** — in pinning mode this
     revalidation is mandatory for stale windows regardless of
     ``validate_checksum``;
  3. a revalidation mismatch on a stale window raises ``StaleGeneration``
     (a ``ChecksumMismatch`` subclass) in strict mode — the window genuinely
     changed (e.g. right-to-delete scrub) and the example must be dropped,
     not silently trained on drifted history.

Batch materialization is *planned* (§4.1.2, §4.2.3): ``materialize_batch``
groups the batch's examples by *window key* — ``(user_id, end_ts, seq_len,
checksum, generation, projection)`` pins the immutable window's exact content
even when per-request lookback ``start_ts`` differs — canonicalizes each
group's scan bounds, and issues ONE ``multi_range_scan`` covering every
example × feature group. The store's planner dedupes the canonicalized
duplicates (surfaced as ``IOStats.dedup_hits``), executes shard groups in
parallel, and decodes each stripe at most once; the materializer then
reassembles per-example UIHs from the shared windows. A true-LRU window cache
(hits promoted) persists windows ACROSS batches, the DPP-worker analogue of
the store-side block cache — all of a user's same-day requests share one
immutable window, so streaming and user-bucketed batch jobs both hit heavily.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import events as ev
from repro_torch.core.projection import TenantProjection, project_view
from repro_torch.core.versioning import TrainingExample, window_checksum
from repro_torch.storage.immutable_store import (
    GenerationUnavailable,
    IOStats,
    ScanRequest,
)
from repro_torch.storage.protocol import StoreProtocol


def _projection_fingerprint(projection: Optional[TenantProjection]):
    """Hashable identity of a projection's *content* for window-cache keys.

    The cache persists across batches, so ``id(projection)`` is unsafe: a
    garbage-collected projection's id can be reused by a different one and
    serve a stale window. TenantProjection itself may hold a dict
    (``traits_per_group``), so it is not reliably hashable — fingerprint the
    fields that affect the fetched window instead."""
    if projection is None:
        return None
    tp = projection.traits_per_group
    return (
        projection.seq_len,
        tuple(projection.feature_groups),
        tuple(sorted((g, tuple(ts)) for g, ts in tp.items())) if tp else None,
    )


class ChecksumMismatch(RuntimeError):
    pass


class StaleGeneration(ChecksumMismatch):
    """The example references a superseded immutable generation whose window is
    no longer reconstructible from the live generation (e.g. right-to-delete
    scrubs changed the event set) and is no longer lease-retained."""


@dataclasses.dataclass
class TenantShareStats:
    """Multi-tenant co-scan amplification accounting (§2.3, Table 1).

    Byte figures are *metadata-exact estimates* (``ImmutableUIHStore.
    estimate_scan`` walks the same stripe selection the scan executes, so
    they match ``IOStats.bytes_scanned`` for a stable generation) — computed
    per co-scanned window against what each tenant's solo scan would have
    read. Accounting is pinned to the generation actually scanned: live
    (gen=-1) fetches record the generation id that was live during the scan
    and estimate against it, so a compaction flip racing fetch and estimate
    cannot attribute the new generation's stripes to this window — if the
    scanned generation has since been dropped (no retaining lease), that
    window skips accounting rather than guessing."""

    co_scans: int = 0                # materialize_multi calls that hit the store
    co_scan_windows: int = 0         # unique windows fetched ONCE for N tenants
    union_bytes_est: int = 0         # blob bytes the union co-scan reads
    solo_bytes_est: int = 0          # Σ blob bytes the per-tenant solo scans would read
    bytes_saved_vs_solo: int = 0     # solo_bytes_est - union_bytes_est (signed)
    union_overfetch_bytes: int = 0   # union bytes beyond the WIDEST single tenant


@dataclasses.dataclass
class MaterializeStats:
    examples: int = 0
    checksum_validated: int = 0
    checksum_failures: int = 0
    immutable_events: int = 0
    mutable_events: int = 0
    window_cache_hits: int = 0   # cross-batch LRU hits (no store round-trip)
    windows_fetched: int = 0     # unique windows fetched from the store
    # stale-generation remediation (bifurcated protocol)
    pinned_windows: int = 0      # served byte-exact from a lease-retained gen
    stale_reresolved: int = 0    # stale windows re-resolved against the live gen
    stale_failures: int = 0      # re-resolved windows whose checksum mismatched
    pin_misses: int = 0          # pinning requested but the gen was already GC'd


class Materializer:
    def __init__(
        self,
        immutable: StoreProtocol,
        schema: ev.TraitSchema,
        validate_checksum: bool = False,
        strict: bool = True,
        window_cache_size: int = 0,
        pin_generations: bool = False,
    ):
        self.immutable = immutable
        self.schema = schema
        self.validate_checksum = validate_checksum
        self.strict = strict
        # Streaming-protocol mode: scan the example's logged generation while a
        # lease retains it (byte-exact); stale windows that must fall back to
        # the live generation are ALWAYS checksum-revalidated.
        self.pin_generations = pin_generations
        self.stats = MaterializeStats()
        # THIS materializer's store traffic. The store's own ``stats`` is
        # shared by every client, so concurrent workers cannot attribute
        # snapshot/delta windows of it to their own lookups; the store
        # accumulates each call's delta here instead.
        self.io_stats = IOStats()
        # True-LRU cache of immutable windows persisting ACROSS batches (the
        # DPP worker analogue of the store-side block cache, §4.2.3): hits are
        # promoted, so a hot user's window survives colder evictions.
        self.window_cache_size = window_cache_size
        self._window_cache: "OrderedDict" = OrderedDict()
        # The LRU is shared by concurrent callers (the serving tier issues
        # materializations from request threads); the promote-on-hit
        # move_to_end / evicting popitem pair corrupts an OrderedDict when
        # interleaved, so both cache ops take this lock. ``stats`` counters
        # remain unsynchronized — they are best-effort telemetry, and a lost
        # increment under contention is harmless where a corrupted cache is
        # not.
        self._cache_lock = threading.Lock()

    # -- single example -------------------------------------------------------
    def materialize(
        self,
        example: TrainingExample,
        projection: Optional[TenantProjection] = None,
    ) -> ev.EventBatch:
        if example.is_fat:
            # Fat Row path: UIH is already materialized; apply projection only.
            return self._project_fat(example, projection)

        assert example.version is not None, "VLM example missing version metadata"
        mutable_part = example.mutable_uih or ev.empty_batch(self.schema)
        immutable_part = self._fetch_immutable(example, projection)
        out = self._concat_and_project(immutable_part, mutable_part, projection)
        self.stats.examples += 1
        self.stats.immutable_events += ev.batch_len(immutable_part)
        self.stats.mutable_events += ev.batch_len(mutable_part)
        return out

    def materialize_batch(
        self,
        examples: Sequence[TrainingExample],
        projection: Optional[TenantProjection] = None,
    ) -> List[ev.EventBatch]:
        """Planned batch path with **data-affinity amortization** (§4.2.3).

        Examples are grouped by window key (same watermark + length + checksum
        => identical immutable event set, even when the lookback ``start_ts``
        differs slightly between adjacent requests). Each group's scan bounds
        are canonicalized to its first example's, and ONE ``multi_range_scan``
        covering every example × feature group goes to the store, whose planner
        dedupes the duplicates and executes shard groups in parallel. Windows
        are then reassembled per example.
        """
        out: List[Optional[ev.EventBatch]] = [None] * len(examples)
        # 1) group VLM examples by window key (batch-local dedupe scope)
        members: "OrderedDict[tuple, List[int]]" = OrderedDict()
        for i, ex in enumerate(examples):
            if ex.is_fat or ex.version is None:
                out[i] = self.materialize(ex, projection)
                continue
            members.setdefault(self._window_key(ex, projection), []).append(i)

        windows, _, _ = self._resolve_windows(members, examples, projection)

        # reassemble per-example UIHs from the shared windows
        for key, idxs in members.items():
            imm = windows[key]
            for i in idxs:
                ex = examples[i]
                mutable_part = ex.mutable_uih or ev.empty_batch(self.schema)
                out[i] = self._concat_and_project(imm, mutable_part, projection)
                self.stats.examples += 1
                self.stats.immutable_events += ev.batch_len(imm)
                self.stats.mutable_events += ev.batch_len(mutable_part)
        return out  # type: ignore[return-value]

    def materialize_multi(
        self,
        examples: Sequence[TrainingExample],
        projections: Sequence[TenantProjection],
        share_stats: Optional[TenantShareStats] = None,
        union: Optional[TenantProjection] = None,
    ) -> Dict[str, List[ev.EventBatch]]:
        """Co-scan materialization for N tenants over ONE window fetch (§2.3,
        §4.2.2): the batch's windows are fetched under the tenants' *union*
        projection (max ``seq_len``, union of feature groups / traits) in one
        planned store round-trip, then each tenant's view is carved host-side
        (``project_view``: tail-slice to its ``seq_len`` + trait projection) —
        byte-identical to that tenant's solo ``materialize_batch`` output.

        ``share_stats`` (optional) accumulates the co-scan's amplification
        savings per fetched window: what every tenant's solo scan would have
        read vs what the union scan reads (``TenantShareStats``).
        ``union`` (optional): the precomputed union of ``projections`` — a
        long-lived caller computes it once instead of per batch.

        Returns ``{tenant.name: [per-example EventBatch]}``. Stats semantics:
        ``stats.examples`` counts per-tenant *outputs* (N per source example),
        matching what N solo passes would have recorded."""
        projections = list(projections)
        if not projections:
            raise ValueError("materialize_multi needs at least one projection")
        names = [p.name for p in projections]
        if len(set(names)) != len(names):
            raise ValueError(f"tenant names must be unique, got {names}")
        if union is None:  # a long-lived caller (planner) passes its own
            union = (projections[0] if len(projections) == 1
                     else TenantProjection.union(projections, self.schema))

        out: Dict[str, List[Optional[ev.EventBatch]]] = {
            p.name: [None] * len(examples) for p in projections}
        members: "OrderedDict[tuple, List[int]]" = OrderedDict()
        for i, ex in enumerate(examples):
            if ex.is_fat or ex.version is None:
                for p in projections:
                    out[p.name][i] = self.materialize(ex, p)
                continue
            members.setdefault(self._window_key(ex, union), []).append(i)

        # hold the scan-time lease through the share estimates so the
        # generation the accounting is pinned to cannot be GC'd (and thus
        # skipped) by a compaction flip racing the estimate
        windows, fetched, lease = self._resolve_windows(
            members, examples, union, hold_lease=share_stats is not None)
        try:
            if share_stats is not None and fetched:
                self._account_share(fetched, projections, union, share_stats)
        finally:
            if lease is not None:
                lease.release()

        for key, idxs in members.items():
            imm = windows[key]
            # carve once per (window, tenant), shared across member examples;
            # a tenant that IS the union (N=1) uses the window as fetched —
            # it was scanned under exactly that projection, the carve is a
            # no-op re-slice/re-project
            views = {p.name: (imm if p is union
                              else project_view(imm, p, self.schema))
                     for p in projections}
            for i in idxs:
                ex = examples[i]
                mutable_part = ex.mutable_uih or ev.empty_batch(self.schema)
                for p in projections:
                    view = views[p.name]
                    out[p.name][i] = self._concat_and_project(
                        view, mutable_part, p)
                    self.stats.examples += 1
                    self.stats.immutable_events += ev.batch_len(view)
                    self.stats.mutable_events += ev.batch_len(mutable_part)
        return out  # type: ignore[return-value]

    def _resolve_windows(
        self,
        members: "OrderedDict[tuple, List[int]]",
        examples: Sequence[TrainingExample],
        projection: Optional[TenantProjection],
        hold_lease: bool = False,
    ):
        """Resolve every unique window key: cross-batch LRU first, then ONE
        planned store round-trip for the misses (with pin-race retry: a pinned
        generation's last lease can release between the availability check and
        the scan — demote ONLY the vanished windows to live re-resolution, so
        a still-leased sibling window keeps its byte-exact pinned service).
        The per-window decision is resolved once (counting each pin miss
        exactly once) and only demoted on retries, never re-derived.

        Returns ``(windows, fetched, lease)`` where ``fetched`` lists the
        ``(key, representative_example, generation)`` triples that actually
        hit the store (cache hits excluded). With ``hold_lease`` (share
        accounting), live (gen=-1) fetches record the generation id a
        transient lease named at scan start and ``lease`` is that lease,
        still held (the caller releases it after estimating against the
        recorded generation). Without it — the trainer's hot path, where the
        triples' generation is never consumed — no lease is taken and
        ``lease`` is ``None``."""
        windows: dict = {}
        to_fetch: List[Tuple[tuple, TrainingExample, int]] = []  # key, rep, n_members
        for key, idxs in members.items():
            cached = self._window_cache_get(key)
            if cached is not None:
                self.stats.window_cache_hits += 1
                windows[key] = cached
                continue
            to_fetch.append((key, examples[idxs[0]], len(idxs)))

        gens: dict = {key: self._window_generation(rep)
                      for key, rep, _ in to_fetch}

        def collect():
            reqs: List[ScanRequest] = []
            spans: List[Tuple[tuple, TrainingExample, int, int, int]] = []
            for key, rep, n_members in to_fetch:
                gen = gens[key]
                canonical = self._requests_for(rep, projection, gen)
                lo = len(reqs)
                # one canonicalized request tuple PER member example: the plan
                # covers example × group, the store dedupes (IOStats.dedup_hits)
                for _ in range(n_members):
                    reqs.extend(canonical)
                spans.append((key, rep, lo, lo + len(canonical), gen))
            return reqs, spans

        fetched: List[Tuple[tuple, TrainingExample, int]] = []
        lease = None
        if to_fetch:
            while True:
                reqs, fetch_spans = collect()
                # share accounting (hold_lease) takes a transient lease that
                # names — and retains — the generation live when the scan
                # STARTS: reading store.generation after the scan would name
                # whatever a racing compaction published in between,
                # mis-attributing the new generation's stripes to this
                # window's share accounting. (gen=-1 requests still resolve
                # per-request, so a mid-scan flip can straddle; audit mode's
                # checksum check catches actual content drift.) Plain fetches
                # never consume the recorded generation, so they skip the
                # lease and its _gen_lock round-trips on the hot path.
                if hold_lease:
                    lease = self.immutable.acquire_lease()
                try:
                    parts = self.immutable.multi_range_scan(reqs, self.io_stats)
                    break
                except GenerationUnavailable:
                    if lease is not None:
                        lease.release()
                        lease = None
                    demoted = False
                    for key in gens:
                        if (gens[key] >= 0
                                and not self.immutable.has_generation(gens[key])):
                            gens[key] = -1
                            self.stats.pin_misses += 1
                            demoted = True
                    if not demoted:
                        # cannot identify the vanished generation (it came
                        # back? paradoxical race) — force everything live to
                        # guarantee termination; live scans never raise
                        for key in gens:
                            gens[key] = -1
                except BaseException:
                    if lease is not None:
                        lease.release()
                    raise
            try:
                live_gen = (lease.generation if lease is not None
                            else self.immutable.generation)
                for key, rep, lo, hi, gen in fetch_spans:
                    imm = self._join_groups(parts[lo:hi])
                    self._maybe_check(rep, imm, projection, gen)
                    self.stats.windows_fetched += 1
                    windows[key] = imm
                    self._window_cache_put(key, imm)
                    fetched.append((key, rep, gen if gen >= 0 else live_gen))
            except BaseException:
                if lease is not None:
                    lease.release()
                raise
        return windows, fetched, lease

    def _account_share(
        self,
        fetched: Sequence[Tuple[tuple, TrainingExample, int]],
        projections: Sequence[TenantProjection],
        union: TenantProjection,
        share_stats: TenantShareStats,
    ) -> None:
        """Per fetched window: what each tenant's solo scan WOULD read vs what
        the union co-scan reads, via the store's metadata-exact estimator."""
        store = self.immutable
        share_stats.co_scans += 1
        for key, rep, gen in fetched:
            try:
                union_b = sum(
                    store.estimate_scan(r)[1]
                    for r in self._requests_for(rep, union, gen))
                solo = [
                    sum(store.estimate_scan(r)[1]
                        for r in self._requests_for(rep, p, gen))
                    for p in projections
                ]
            except GenerationUnavailable:
                continue  # the generation flipped after the fetch; skip
            share_stats.co_scan_windows += 1
            share_stats.union_bytes_est += union_b
            share_stats.solo_bytes_est += sum(solo)
            share_stats.bytes_saved_vs_solo += sum(solo) - union_b
            share_stats.union_overfetch_bytes += max(0, union_b - max(solo))

    # -- helpers ---------------------------------------------------------------
    def _window_key(
        self, example: TrainingExample, projection: Optional[TenantProjection]
    ) -> tuple:
        """Pins the *content* of an immutable window: same watermark + same
        length + same checksum => identical event set regardless of the
        per-request lookback start_ts."""
        v = example.version
        return (example.user_id, v.end_ts, v.seq_len, v.checksum, v.generation,
                _projection_fingerprint(projection))

    def _window_cache_get(self, key: tuple) -> Optional[ev.EventBatch]:
        if not self.window_cache_size:
            return None
        with self._cache_lock:
            hit = self._window_cache.get(key)
            if hit is not None:
                self._window_cache.move_to_end(key)  # true LRU: promote on hit
            return hit

    def _window_cache_put(self, key: tuple, imm: ev.EventBatch) -> None:
        if not self.window_cache_size:
            return
        with self._cache_lock:
            self._window_cache[key] = imm
            self._window_cache.move_to_end(key)
            while len(self._window_cache) > self.window_cache_size:
                self._window_cache.popitem(last=False)

    def _window_generation(self, example: TrainingExample) -> int:
        """Resolve which generation serves this example's window: the logged
        generation while a lease retains it (pinning mode), else -1 = live
        re-resolve (remediation)."""
        meta = example.version
        assert meta is not None
        if not self.pin_generations or meta.generation < 0:
            return -1
        if self.immutable.has_generation(meta.generation):
            return meta.generation
        self.stats.pin_misses += 1
        return -1

    def _requests_for(
        self,
        example: TrainingExample,
        projection: Optional[TenantProjection],
        generation: int = -1,
    ) -> List[ScanRequest]:
        """One ScanRequest per feature group for the example's window.

        Sequence-length projection: the tenant wants the *most recent*
        ``projection.seq_len`` events of the full UIH. The immutable fetch uses
        the full tenant budget (not seq_len - n_mutable) so the fetched window
        is shareable across same-user examples whose mutable slices differ;
        the final concat+trim keeps exactly seq_len events."""
        meta = example.version
        assert meta is not None
        groups = (
            projection.feature_groups
            if projection is not None
            else tuple(self.schema.feature_groups)
        )
        max_events = -1 if projection is None else projection.seq_len
        return [
            ScanRequest(
                user_id=example.user_id,
                group=g,
                start_ts=meta.start_ts,
                end_ts=meta.end_ts,
                max_events=meta.seq_len if max_events < 0 else max_events,
                traits=None if projection is None else projection.traits_for(self.schema, g),
                generation=generation,
            )
            for g in groups
        ]

    def _fetch_immutable(
        self, example: TrainingExample, projection: Optional[TenantProjection]
    ) -> ev.EventBatch:
        gen = self._window_generation(example)
        try:
            parts = self.immutable.multi_range_scan(
                self._requests_for(example, projection, gen), self.io_stats)
        except GenerationUnavailable:
            # pinned generation GC'd between check and scan: remediate live
            self.stats.pin_misses += 1
            gen = -1
            parts = self.immutable.multi_range_scan(
                self._requests_for(example, projection, gen), self.io_stats)
        imm = self._join_groups(parts)
        self._maybe_check(example, imm, projection, gen)
        self.stats.windows_fetched += 1
        return imm

    def _maybe_check(
        self,
        example: TrainingExample,
        imm: ev.EventBatch,
        projection: Optional[TenantProjection],
        used_generation: int = -1,
    ) -> None:
        """Checksum-validate iff the full window was fetched (a projected
        fetch can legitimately differ from the snapshot-time window).

        ``used_generation``: the generation the window was actually scanned
        from. A window served pinned is byte-exact by construction; a STALE
        window re-resolved against the live generation is the remediation
        path, and in pinning mode its revalidation is mandatory."""
        meta = example.version
        assert meta is not None
        # examples logged before the first compaction (generation -1) have no
        # generation to go stale — there was never a pinned window
        stale = (meta.generation >= 0
                 and meta.generation != self.immutable.generation)
        pinned = used_generation >= 0 and stale
        if pinned:
            self.stats.pinned_windows += 1
        elif stale:
            self.stats.stale_reresolved += 1
        must_validate = self.validate_checksum or (
            self.pin_generations and stale and not pinned)
        max_events = -1 if projection is None else projection.seq_len
        if (must_validate and meta.checksum
                and self._wants_full_window(projection, meta.seq_len, max_events)):
            self._check(example, imm, meta, stale=stale and not pinned)

    def _wants_full_window(self, projection, snap_len: int, max_events: int) -> bool:
        return projection is None or max_events >= snap_len

    def _join_groups(self, parts: Sequence[ev.EventBatch]) -> ev.EventBatch:
        """Feature groups are horizontal partitions of the SAME event sequence
        (compaction cuts one history into per-group stripes), so after applying
        identical temporal bounds + length budget they are position-aligned."""
        joined: ev.EventBatch = {}
        n = None
        for p in parts:
            if n is None:
                n = ev.batch_len(p)
            else:
                assert ev.batch_len(p) == n, "feature groups misaligned"
                if n and "timestamp" in joined:
                    assert np.array_equal(joined["timestamp"], p["timestamp"])
            joined.update(p)
        return joined

    def _check(self, example, immutable_part: ev.EventBatch, meta,
               stale: bool = False) -> None:
        need = {"timestamp", "item_id"}
        if not need <= set(immutable_part):
            return  # projection dropped identity columns; cannot validate
        self.stats.checksum_validated += 1
        got = window_checksum(immutable_part)
        if got != meta.checksum or ev.batch_len(immutable_part) != meta.seq_len:
            self.stats.checksum_failures += 1
            if stale:
                self.stats.stale_failures += 1
            if self.strict:
                exc = StaleGeneration if stale else ChecksumMismatch
                raise exc(
                    f"request {example.request_id}: immutable window changed "
                    f"(gen {meta.generation} -> {self.immutable.generation}); "
                    f"len {meta.seq_len} -> {ev.batch_len(immutable_part)}"
                    + ("; re-resolution against the live generation could not "
                       "reproduce the logged window" if stale else "")
                )

    def _concat_and_project(
        self,
        immutable_part: ev.EventBatch,
        mutable_part: ev.EventBatch,
        projection: Optional[TenantProjection],
    ) -> ev.EventBatch:
        if projection is not None:
            traits = projection.all_traits(self.schema)
            mutable_part = ev.project_traits(mutable_part, [t for t in traits if t in mutable_part])
            if immutable_part:
                immutable_part = ev.project_traits(
                    immutable_part, [t for t in traits if t in immutable_part]
                )
        full = ev.concat_batches([immutable_part, mutable_part])
        if not full:
            cols = (
                projection.all_traits(self.schema)
                if projection is not None
                else self.schema.trait_names
            )
            return ev.empty_batch(self.schema, cols)
        if projection is not None:
            n = ev.batch_len(full)
            if n > projection.seq_len:
                full = ev.slice_batch(full, n - projection.seq_len, n)
        return full

    def _project_fat(
        self, example: TrainingExample, projection: Optional[TenantProjection]
    ) -> ev.EventBatch:
        """Fat Row tenants must filter client-side — the monolithic row has
        already been read in full (this is the multi-tenant penalty)."""
        fat = example.fat_uih or ev.empty_batch(self.schema)
        if projection is None:
            return fat
        traits = [t for t in projection.all_traits(self.schema) if t in fat]
        out = ev.project_traits(fat, traits)
        n = ev.batch_len(out)
        if n > projection.seq_len:
            out = ev.slice_batch(out, n - projection.seq_len, n)
        return out
