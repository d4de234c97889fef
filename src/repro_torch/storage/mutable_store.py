"""Real-time mutable UIH store (paper §4.1.1).

Captures the most recent engagements with second-level freshness. To support
high-frequency updates without a Read-Modify-Write penalty, writes are
*blind-write appends* (unsorted chunks per user); state resolution (sort +
merge) is deferred to read time or to background compaction. A write-through
cache co-located with the ranking service serves the read path.

Retention is coupled to the immutable store's compaction cadence: events must
stay in the mutable tier until the next compaction cycle has consolidated them
into the immutable tier (``evict_until``)."""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import events as ev


class MutableUIHStore:
    def __init__(self, schema: Optional[ev.TraitSchema] = None):
        self.schema = schema or ev.default_schema()
        self._chunks: Dict[int, List[ev.EventBatch]] = {}
        # write-through cache of the merged view, invalidated on append
        self._cache: Dict[int, ev.EventBatch] = {}
        # append/evict mutual exclusion: eviction's merge->install sequence
        # must not lose a concurrent blind-write (or re-publish a cached view
        # missing it); reads stay lock-free
        self._write_lock = threading.Lock()
        # per-user write-state version: bumped on every append and eviction.
        # O(1) freshness probe for serving-side caches — an unchanged version
        # guarantees an unchanged merged view (the converse is conservative:
        # an eviction below a reader's window bumps it without changing that
        # reader's slice, which can only cause a spurious recompute)
        self._versions: Dict[int, int] = {}
        # accounting for benchmarks
        self.bytes_written = 0
        self.bytes_read = 0
        self.appends = 0
        self.evict_cache_hits = 0   # evictions served from the merged-view cache
        self.evict_merges = 0       # evictions that had to re-merge chunks

    # -- write path ---------------------------------------------------------
    def append(self, user_id: int, batch: ev.EventBatch) -> None:
        """Blind-write append: no read, no sort, O(1) amortized."""
        if ev.batch_len(batch) == 0:
            return
        with self._write_lock:
            self._chunks.setdefault(user_id, []).append(batch)
            self._cache.pop(user_id, None)
            self._versions[user_id] = self._versions.get(user_id, 0) + 1
        self.appends += 1
        self.bytes_written += sum(v.nbytes for v in batch.values())

    # -- read path ----------------------------------------------------------
    def read(self, user_id: int, t_lo: int, t_hi: int) -> ev.EventBatch:
        """Merged, time-ordered view of recent events in (t_lo, t_hi].

        Merge-on-read resolves the unsorted blind-write chunks; the merged view
        is cached (write-through cache) until the next append."""
        merged = self._cache.get(user_id)
        if merged is None:
            chunks = self._chunks.get(user_id, [])
            n0 = len(chunks)
            merged = ev.merge_sorted(chunks)
            if not merged:
                merged = ev.empty_batch(self.schema)
            with self._write_lock:
                # install only if no append/evict raced the merge: eviction
                # trusts the cache as authoritative, so a stale install here
                # would let it write back a view missing the new chunk
                if (self._chunks.get(user_id) is chunks
                        and len(chunks) == n0):
                    self._cache[user_id] = merged
        out = ev.time_slice(merged, t_lo + 1, t_hi)
        self.bytes_read += sum(v.nbytes for v in out.values())
        return out

    # -- retention ----------------------------------------------------------
    def evict_until(self, user_id: int, watermark_ts: int) -> None:
        """Drop events with timestamp <= watermark (already compacted into the
        immutable tier). Called after each compaction cycle.

        Reuses the write-through cache's merged view when valid (it is
        invalidated on every append, so a present entry IS the chunks' merge)
        instead of re-merging every chunk list on each cycle; the surviving
        suffix is written back so the next read is also merge-free."""
        with self._write_lock:
            chunks = self._chunks.get(user_id)
            if not chunks:
                return
            self._versions[user_id] = self._versions.get(user_id, 0) + 1
            merged = self._cache.get(user_id)
            if merged is None or ev.batch_len(merged) == 0:
                merged = ev.merge_sorted(chunks)
                self.evict_merges += 1
            else:
                self.evict_cache_hits += 1
            ts = merged["timestamp"]
            keep_from = int(np.searchsorted(ts, watermark_ts, side="right"))
            kept = ev.slice_batch(merged, keep_from, len(ts))
            if ev.batch_len(kept) == 0:
                self._chunks.pop(user_id, None)
                self._cache.pop(user_id, None)
            else:
                self._chunks[user_id] = [kept]
                self._cache[user_id] = kept

    def evict_all_until(self, watermark_ts: int) -> None:
        for uid in list(self._chunks.keys()):
            self.evict_until(uid, watermark_ts)

    def user_ids(self):
        return list(self._chunks.keys())

    def resident_events(self, user_id: int) -> int:
        return sum(ev.batch_len(c) for c in self._chunks.get(user_id, []))

    def version(self, user_id: int) -> int:
        """Monotone per-user write-state version (0 = never written). Equal
        versions imply an identical merged view; a bump means *something*
        changed and any derived cache entry must be recomputed."""
        return self._versions.get(user_id, 0)
