"""Replicated store tier under failure (DESIGN.md §12).

Three claims, on the same heavy-tailed population as ``bench_sharded_store``:
  * availability — with one of four nodes down, an r=2 tier keeps serving
    every read at throughput close to healthy (acceptance: within ~25%),
    while r=1 can only surface the outage as retryable ``NodeUnavailable``
    (reported as the unavailable-batch rate, never hidden);
  * tail latency — quantile-triggered hedged reads cut p99 against an
    injected-slow node, at the cost of duplicate I/O (``hedged_reads`` /
    ``hedge_wins`` reported);
  * recovery — time from ``recover()`` on a flapped node (missed-generation
    replay + orphan-lease settlement) back to the primary serving reads.

Port of ``benchmarks/bench_failover.py`` over the port's replicated
``ShardedUIHStore``; ``LATENCY`` and ``_population`` come from the port's
``bench_sharded_store``. No departure. Host-only: nothing reaches the card.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmarks_torch.bench_sharded_store import LATENCY, _population
from benchmarks_torch.common import BenchResult
from repro_torch.core import events as ev
from repro_torch.storage.compaction import CompactionConfig, CompactionPipeline
from repro_torch.storage.failover import CLOSED
from repro_torch.storage.immutable_store import ScanRequest
from repro_torch.storage.sharded_store import NodeUnavailable, ShardedUIHStore

SCHEMA = ev.default_schema()
N_NODES = 4
DOWN_NODE = 1


def _build(events: Dict[int, ev.EventBatch], replication: int,
           generation: int = 0, store: ShardedUIHStore = None,
           **kw) -> ShardedUIHStore:
    if store is None:
        store = ShardedUIHStore(SCHEMA, n_shards=8, n_nodes=N_NODES,
                                replication_factor=replication, **kw)
    pipe = CompactionPipeline(SCHEMA, CompactionConfig(stripe_len=64))
    pipe.run(lambda uid, lo, hi: ev.time_slice(events[uid], lo, hi),
             list(events), 1_000_000, store, generation=generation)
    return store


def _scan_sweep(store: ShardedUIHStore, users: List[int], batch: int,
                repeats: int):
    """Batched scans over the population; a batch whose node group is fully
    unavailable counts as failed (r=1 with a node down) instead of aborting
    the sweep. Returns (wall_s, rows_ok, batches_failed)."""
    rows_ok, failed = 0, 0
    t0 = time.perf_counter()
    for _ in range(repeats):
        for lo in range(0, len(users), batch):
            chunk = users[lo:lo + batch]
            reqs = [ScanRequest(u, "core", 0, 10**9) for u in chunk]
            try:
                store.multi_range_scan(reqs)
                rows_ok += len(chunk)
            except NodeUnavailable:
                failed += 1
    return time.perf_counter() - t0, rows_ok, failed


def run(quick: bool = False) -> List[BenchResult]:
    n_users, mean_events, batch, repeats = \
        (24, 30, 8, 2) if quick else (128, 80, 16, 4)
    events = _population(n_users, mean_events)
    users = list(events)
    results: List[BenchResult] = []

    # -- availability: rows/s with 0 vs 1 node down, r in {1, 2} -------------
    thr = {}
    for repl in (1, 2):
        for down in (False, True):
            store = _build(events, repl)
            store.latency_model = LATENCY
            if down:
                store.set_node_down(DOWN_NODE)
            wall, rows_ok, failed = _scan_sweep(store, users, batch, repeats)
            n_batches = repeats * ((len(users) + batch - 1) // batch)
            thr[(repl, down)] = {
                "rows_per_s": round(rows_ok / wall, 1),
                "unavailable_batch_rate": round(failed / n_batches, 3),
                "failovers": store.stats.failovers,
                "breaker_opens": store.stats.breaker_opens,
            }
            store.close()
    healthy = thr[(2, False)]["rows_per_s"]
    degraded = thr[(2, True)]["rows_per_s"]
    results.append(BenchResult(
        "failover/throughput_one_node_down", 0.0,
        {"r1_healthy_rows_per_s": thr[(1, False)]["rows_per_s"],
         "r1_down_rows_per_s": thr[(1, True)]["rows_per_s"],
         # r=1 cannot mask the outage: the rate is the honest signal
         "r1_down_unavailable_rate": thr[(1, True)]["unavailable_batch_rate"],
         "r2_healthy_rows_per_s": healthy,
         "r2_down_rows_per_s": degraded,
         "r2_down_vs_healthy": round(degraded / healthy, 3),
         "r2_down_failovers": thr[(2, True)]["failovers"],
         "r2_down_breaker_opens": thr[(2, True)]["breaker_opens"]},
    ))

    # -- tail latency: hedging off vs on against one slow node ---------------
    slow_factor = 8.0
    n_probe = 40 if quick else 160
    lat = {}
    for hedge in (0.0, 0.7):
        store = _build(events, 2, hedge_quantile=hedge)
        store.latency_model = LATENCY
        warm = [ScanRequest(u, "core", 0, 10**9) for u in users[:20]]
        for r in warm:                       # warm the tier latency tracker
            store.scan(r)
        store.set_node_slow(0, slow_factor)
        samples = []
        for i in range(n_probe):
            req = ScanRequest(users[i % len(users)], "core", 0, 10**9)
            t0 = time.perf_counter()
            store.scan(req)
            samples.append(time.perf_counter() - t0)
        s = store.stats
        lat[hedge] = {
            "p50_ms": round(float(np.percentile(samples, 50)) * 1e3, 3),
            "p99_ms": round(float(np.percentile(samples, 99)) * 1e3, 3),
            "hedged_reads": s.hedged_reads,
            "hedge_wins": s.hedge_wins,
        }
        store.close()
    results.append(BenchResult(
        "failover/hedged_read_tail_latency",
        lat[0.7]["p99_ms"] * 1e3,
        {"slow_factor": slow_factor,
         "p99_ms_no_hedge": lat[0.0]["p99_ms"],
         "p99_ms_hedged": lat[0.7]["p99_ms"],
         "p50_ms_no_hedge": lat[0.0]["p50_ms"],
         "p50_ms_hedged": lat[0.7]["p50_ms"],
         "hedged_reads": lat[0.7]["hedged_reads"],
         "hedge_wins": lat[0.7]["hedge_wins"]},
    ))

    # -- recovery: flapped node back to serving reads ------------------------
    store = _build(events, 2)
    store.set_node_down(DOWN_NODE)
    _scan_sweep(store, users, batch, 1)      # outage traffic: breaker trips
    _build(events, 2, generation=1, store=store)   # missed load -> replay
    assert store.node_stats().pending_replays[DOWN_NODE] == 1
    t0 = time.perf_counter()
    replayed = store.recover(DOWN_NODE)
    recover_ms = (time.perf_counter() - t0) * 1e3
    # ...to healthy: the primary serves again and its breaker is closed
    probe_user = next(u for u in users
                      if store._node_of(u) == DOWN_NODE)
    scans_to_healthy = 0
    base = store.nodes[DOWN_NODE].stats.requests
    while (store.nodes[DOWN_NODE].stats.requests == base
           or store.node_stats().breaker[DOWN_NODE] != CLOSED):
        store.scan(ScanRequest(probe_user, "core", 0, 10**9))
        scans_to_healthy += 1
    healthy_ms = (time.perf_counter() - t0) * 1e3
    results.append(BenchResult(
        "failover/recovery_time_to_healthy", recover_ms * 1e3,
        {"recover_ms": round(recover_ms, 3),
         "time_to_healthy_ms": round(healthy_ms, 3),
         "generations_replayed": replayed,
         "rereplicated_bytes": store.rereplicated_bytes,
         "scans_to_healthy": scans_to_healthy},
    ))
    store.close()
    return results


if __name__ == "__main__":
    for r in run():
        print(r.csv())
