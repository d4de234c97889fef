"""Symmetric hash partitioning + length-aware node placement (paper §4.2.3).

The primary training data and the immutable UIH store use the *identical* hash
partitioning scheme with a shared partition key (user_id), so that all UIH
lookups issued while loading one data batch map to the same storage shard —
eliminating cross-shard network fanout on the high-concurrency read path.

With the store disaggregated across N nodes (``storage.sharded_store``), pure
hashing is no longer enough: ultra-long-UIH power users are orders of
magnitude heavier than the torso, and a hash that is uniform in *users* is
badly skewed in *bytes* (FlexShard, 2301.02959). Placement is therefore
two-level:

  * torso users route by hash — ``shard_of(user, n_shards)`` picks the logical
    shard, ``node_of_shard`` maps shards round-robin onto nodes;
  * the heavy tail gets an **explicit balanced assignment**: the top-loaded
    users are greedily packed (longest-first) onto the least-loaded node, and
    the resulting ``user -> node`` override map is carried as *generation
    metadata* (``PlacementMap``) so every reader — store client, DPP affinity
    planner, multi-tenant planner — routes identically, and a pinned scan on a
    retained generation still finds the bytes where that generation placed
    them, even after a later rebalance moved the user.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple


def shard_of(user_id: int, n_shards: int) -> int:
    """Deterministic, stable hash partition. Shared by trainer-data placement
    and by the immutable store so sharding stays *symmetric*."""
    # splitmix64-style mix; stable across processes (unlike hash()).
    x = (user_id & 0xFFFFFFFFFFFFFFFF) * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 32
    x = x * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 29
    return int(x % n_shards)


def node_of_shard(shard: int, n_nodes: int) -> int:
    """Default shard -> store-node mapping (round-robin): contiguous shards
    interleave across nodes so a shard-sorted scan workload spreads out."""
    return shard % n_nodes


@dataclasses.dataclass(frozen=True)
class PlacementMap:
    """User -> store-node routing for ONE immutable generation.

    Torso users resolve through the symmetric hash (``shard_of`` then
    ``node_of_shard``); ``overrides`` pins the heavy tail explicitly. The map
    is immutable and carried per generation: the sharded store retains the map
    of every leased/retained generation so pinned scans route to where that
    generation's bulk load actually put the bytes.

    **Replication** (``replication_factor`` = r): length-aware LPT placement
    decides the PRIMARY only; the r-1 replicas follow round-robin from the
    primary — ``(primary + k) % n_nodes`` for k in 1..r-1 — which is the
    anti-affinity rule: consecutive offsets are distinct nodes, so no two
    copies of a user's stripes ever share a node (for r <= n_nodes). The
    chain is part of the placement map, i.e. generation metadata: a pinned
    scan's failover targets are the replicas *that generation* loaded to."""

    n_nodes: int
    n_shards: int
    overrides: Mapping[int, int] = dataclasses.field(default_factory=dict)
    replication_factor: int = 1

    def node_of(self, user_id: int) -> int:
        node = self.overrides.get(int(user_id))
        if node is not None:
            return node
        return node_of_shard(shard_of(user_id, self.n_shards), self.n_nodes)

    def replicas_of(self, user_id: int) -> Tuple[int, ...]:
        """Ordered replica chain for a user: primary first, then the
        round-robin anti-affine successors. Readers prefer the head; the
        failover executor walks the tail."""
        primary = self.node_of(user_id)
        r = max(1, min(self.replication_factor, self.n_nodes))
        return tuple((primary + k) % self.n_nodes for k in range(r))

    def shard_of(self, user_id: int) -> int:
        return shard_of(user_id, self.n_shards)


def length_aware_overrides(
    loads: Mapping[int, int],
    n_nodes: int,
    n_shards: int,
    heavy_tail_fraction: float = 0.05,
    heavy_load_ratio: float = 2.0,
) -> Dict[int, int]:
    """FlexShard-style heavy-tail assignment: pick the ultra-long users and
    balance them explicitly instead of trusting the hash.

    ``loads`` maps user_id -> load (stripe blob bytes is the natural currency:
    it is exactly what a full-window scan reads). The heavy set is the top
    ``heavy_tail_fraction`` of users by load, restricted to users whose load
    exceeds ``heavy_load_ratio`` x the mean (a uniform population yields no
    overrides — hash placement is already balanced there). Heavy users are
    then packed longest-first onto the least-loaded node (greedy LPT), with
    each node's load seeded by the hash-routed torso it already owns.

    Deterministic: ties break on user_id, so the same loads always produce
    the same map."""
    if n_nodes <= 1 or not loads:
        return {}
    mean = sum(loads.values()) / len(loads)
    k = max(1, math.ceil(heavy_tail_fraction * len(loads)))
    ranked = sorted(loads.items(), key=lambda kv: (-kv[1], kv[0]))
    heavy = [(u, b) for u, b in ranked[:k] if b > heavy_load_ratio * mean]
    if not heavy:
        return {}
    heavy_ids = {u for u, _ in heavy}
    node_load = [0] * n_nodes
    for u, b in loads.items():
        if u not in heavy_ids:
            node_load[node_of_shard(shard_of(u, n_shards), n_nodes)] += b
    overrides: Dict[int, int] = {}
    for u, b in heavy:  # already longest-first
        target = min(range(n_nodes), key=lambda n: (node_load[n], n))
        overrides[u] = target
        node_load[target] += b
    return overrides


class ShardRouter:
    """``salt=0`` (the default) is the canonical symmetric placement —
    byte-identical to bare ``shard_of``. A non-zero salt decorrelates a
    NESTED partition from its parent: ``shard_of(u, a*b) % b == shard_of(u,
    b)`` for the same mix value, so a store node re-sharding its local slice
    of a hash-partitioned population with the unsalted hash would collapse
    every resident user into one local shard (zero local parallelism)."""

    def __init__(self, n_shards: int, salt: int = 0):
        assert n_shards >= 1
        self.n_shards = n_shards
        self.salt = salt

    def route(self, user_id: int) -> int:
        return shard_of(int(user_id) ^ self.salt, self.n_shards)

    def fanout(self, user_ids) -> int:
        """Number of distinct shards touched by a batch of lookups."""
        return len({self.route(int(u)) for u in user_ids})
