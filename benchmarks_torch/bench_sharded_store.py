"""Disaggregated immutable tier (DESIGN.md §11): FlexShard-style placement.

Two claims, on a heavy-tailed (Pareto-ish) user population:
  * length-aware placement cuts the MAX-node load ratio vs pure hashing —
    ultra-long users stop hot-spotting one node (FlexShard, 2301.02959);
  * batched-scan throughput scales with node count {1, 2, 4} under a
    remote-I/O latency model (node groups execute concurrently, so wall time
    per batch is the max over nodes, not the sum).

Port of ``benchmarks/bench_sharded_store.py`` over the port's
``ShardedUIHStore``; no departure. Host-only: nothing reaches the card.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmarks_torch.common import BenchResult
from repro_torch.core import events as ev
from repro_torch.storage.compaction import CompactionConfig, CompactionPipeline
from repro_torch.storage.immutable_store import ScanRequest
from repro_torch.storage.sharded_store import ShardedUIHStore

SCHEMA = ev.default_schema()
N_SHARDS = 8

# remote-storage latency model, charged per shard of each node round-trip
# (heavy enough that remote I/O dominates host-side decode, as it does for a
# genuinely disaggregated tier)
LATENCY = (lambda seeks, nbytes, fanout:
           1e-2 * seeks + nbytes / 3e7 + 5e-4 * max(fanout - 1, 0))


def _population(n_users: int, mean_events: int, seed: int = 7
                ) -> Dict[int, ev.EventBatch]:
    """Heavy-tailed event counts: a Pareto tail over a uniform torso — the
    top ~5% of users carry the majority of bytes, like production UIH."""
    rng = np.random.default_rng(seed)
    counts = (mean_events * (1.0 + rng.pareto(1.1, n_users) * 3.0)).astype(int)
    events = {}
    for uid in range(n_users):
        # cap the tail at 25x the mean: ultra-long, but no single user so
        # pathological that it alone serializes every configuration
        n = int(min(counts[uid], mean_events * 25))
        per_user = np.random.default_rng(seed + uid + 1)
        batch = {}
        for name in SCHEMA.trait_names:
            dt = SCHEMA.spec(name).dtype
            batch[name] = per_user.integers(0, 1_000, n).astype(dt)
        batch["timestamp"] = np.sort(
            per_user.integers(0, 900_000, n)).astype(np.int64)
        events[uid] = batch
    return events


def _build(events: Dict[int, ev.EventBatch], n_nodes: int,
           policy: str, n_shards: int = N_SHARDS) -> ShardedUIHStore:
    store = ShardedUIHStore(SCHEMA, n_shards=n_shards, n_nodes=n_nodes,
                            placement_policy=policy)
    pipe = CompactionPipeline(SCHEMA, CompactionConfig(stripe_len=64))
    pipe.run(lambda uid, lo, hi: ev.time_slice(events[uid], lo, hi),
             list(events), 1_000_000, store, generation=0)
    return store


def _scan_all(store: ShardedUIHStore, users: List[int],
              batch_size: int) -> float:
    """Full-window batched scans over every user; returns wall seconds."""
    t0 = time.perf_counter()
    for lo in range(0, len(users), batch_size):
        reqs = [ScanRequest(u, "core", 0, 10**9)
                for u in users[lo:lo + batch_size]]
        store.multi_range_scan(reqs)
    return time.perf_counter() - t0


def run(quick: bool = False) -> List[BenchResult]:
    n_users, mean_events, batch = (32, 40, 8) if quick else (256, 120, 32)
    events = _population(n_users, mean_events)
    users = list(events)

    # -- skew: hash vs length-aware on 4 nodes -------------------------------
    results: List[BenchResult] = []
    skews = {}
    for policy in ("hash", "length_aware"):
        store = _build(events, 4, policy)
        _scan_all(store, users, batch)
        ns = store.node_stats()
        skews[policy] = ns
        store.close()
    results.append(BenchResult(
        "sharded_store/max_node_load", 0.0,
        {"hash_max_mean": round(skews["hash"].max_mean_load_ratio, 3),
         "length_aware_max_mean":
             round(skews["length_aware"].max_mean_load_ratio, 3),
         "hash_stored_max_mean":
             round(skews["hash"].max_mean_stored_ratio, 3),
         "length_aware_stored_max_mean":
             round(skews["length_aware"].max_mean_stored_ratio, 3),
         "hash_node_bytes": skews["hash"].scan_load,
         "length_aware_node_bytes": skews["length_aware"].scan_load},
    ))

    # -- throughput scaling over node counts {1, 2, 4} -----------------------
    # scale-out semantics: each node brings its own fixed local parallelism
    # (2 shards/node), so 4 nodes really is 4x the 1-node I/O capacity
    walls = {}
    for n_nodes in (1, 2, 4):
        store = _build(events, n_nodes, "length_aware",
                       n_shards=2 * n_nodes)
        store.latency_model = LATENCY
        wall = _scan_all(store, users, batch)
        store.latency_model = None
        walls[n_nodes] = wall
        store.close()
    thr = {n: len(users) / w for n, w in walls.items()}
    results.append(BenchResult(
        "sharded_store/scan_throughput_scaling",
        walls[4] / len(users) * 1e6,
        {"users_per_s_1node": round(thr[1], 1),
         "users_per_s_2node": round(thr[2], 1),
         "users_per_s_4node": round(thr[4], 1),
         "speedup_2node": round(thr[2] / thr[1], 2),
         "speedup_4node": round(thr[4] / thr[1], 2)},
    ))
    return results


if __name__ == "__main__":
    for r in run():
        print(r.csv())
