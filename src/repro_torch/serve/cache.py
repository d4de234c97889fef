"""Per-user materialized-embedding cache (DESIGN.md §14.4).

A bounded, lock-protected LRU mapping ``user_id`` to the user-tower embedding
computed from that user's fully materialized UIH, tagged with the exact store
state it was computed against:

    (generation, freshness)  where
    freshness = (start_ts, end_ts, request_ts, mutable_version)

A lookup hits ONLY if both tags match the state the current request resolved
under its lease — a generation flip (compaction published a new immutable
view) or any change in the user's visible event set (new mutable events,
advanced watermark, shifted lookback window) makes the entry unusable and
evicts it on the spot, classified as ``invalidated_generation`` /
``invalidated_freshness``. ``mutable_version`` is the mutable tier's O(1)
per-user write-state counter (``MutableUIHStore.version``): an unchanged
version guarantees an unchanged merged view, so the probe needs NO mutable
read at all on a hit; a bump (append or eviction) is conservative — it can
only force a spurious recompute, never serve a stale slice. The immutable
window is pinned by ``(generation, start_ts, end_ts)`` and the mutable slice
by ``(end_ts, request_ts, mutable_version)``.

A hit therefore serves bytes identical to a fresh scan+featurize+encode —
the cache is a pure latency optimization, never a staleness trade.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class EmbedCacheStats:
    lookups: int = 0                  # get() calls
    hits: int = 0                     # tag-exact hits (embedding reused)
    misses: int = 0                   # absent or invalidated entries
    invalidated_generation: int = 0   # dropped: entry's generation superseded
    invalidated_freshness: int = 0    # dropped: user's visible event set changed
    evictions: int = 0                # dropped by LRU capacity pressure
    inserts: int = 0                  # put() calls that stored an embedding


class UserEmbeddingCache:
    """Bounded LRU of user-tower embeddings, validated by (generation,
    freshness) tags. Thread-safe: serving workers share one instance."""

    def __init__(self, capacity: int = 2048):
        assert capacity >= 1
        self.capacity = capacity
        self.stats = EmbedCacheStats()
        self._lock = threading.Lock()
        # user_id -> (generation, freshness, embedding)
        self._entries: "OrderedDict[int, Tuple[int, tuple, np.ndarray]]" = (
            OrderedDict())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, user_id: int, generation: int,
            freshness: tuple) -> Tuple[Optional[np.ndarray], str]:
        """Return ``(embedding, "hit")`` iff the cached entry was computed
        against exactly this (generation, freshness); else ``(None, reason)``
        with reason in ``{"miss", "generation", "freshness"}`` (the two
        invalidation reasons also drop the dead entry)."""
        with self._lock:
            self.stats.lookups += 1
            entry = self._entries.get(user_id)
            if entry is None:
                self.stats.misses += 1
                return None, "miss"
            gen, fresh, emb = entry
            if gen != generation:
                del self._entries[user_id]
                self.stats.invalidated_generation += 1
                self.stats.misses += 1
                return None, "generation"
            if fresh != freshness:
                del self._entries[user_id]
                self.stats.invalidated_freshness += 1
                self.stats.misses += 1
                return None, "freshness"
            self._entries.move_to_end(user_id)  # true LRU: promote on hit
            self.stats.hits += 1
            return emb, "hit"

    def put(self, user_id: int, generation: int, freshness: tuple,
            embedding: np.ndarray) -> None:
        with self._lock:
            self._entries[user_id] = (generation, freshness, embedding)
            self._entries.move_to_end(user_id)
            self.stats.inserts += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1

    def invalidate_user(self, user_id: int) -> bool:
        with self._lock:
            return self._entries.pop(user_id, None) is not None

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
