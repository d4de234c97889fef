"""Planned multi-range scan vs per-example scans (§4.1.2, §4.2.3).

Duplicate-heavy workload: user-bucketed batches where many same-user, same-day
examples share one immutable window. The planned path must (a) execute fewer
scans (dedupe), (b) decode fewer stripes (decode LRU), and (c) overlap shard
I/O (per-shard latency instead of summed) — byte-identical outputs are proven
in tests/test_scan_plan.py, and for the port in
tests/test_torch_benchmarks_quick.py.

Port of ``benchmarks/bench_scan_plan.py`` over the port's
``storage.columnar`` and ``Materializer``; no departure. Host-only:
nothing reaches the card.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import List

from benchmarks_torch.common import BenchResult, standard_sim
from repro_torch.core.projection import TenantProjection
from repro_torch.storage import columnar

TENANT = TenantProjection("t", seq_len=256,
                          feature_groups=("core", "engagement"))

# remote-storage latency model: per-seek + per-byte + per-shard-hop
LATENCY = (lambda seeks, nbytes, fanout:
           2e-4 * seeks + nbytes / 2e9 + 5e-4 * max(fanout - 1, 0))


def _user_bucketed_batches(sim, base: int = 16) -> List[list]:
    by_user = defaultdict(list)
    for e in sim.examples:
        if e.version is not None:
            by_user[e.user_id].append(e)
    batches, cur = [], []
    for u in sorted(by_user):
        for e in by_user[u]:
            cur.append(e)
            if len(cur) == base:
                batches.append(cur)
                cur = []
    if cur:
        batches.append(cur)
    return batches


def _run(sim, batches, planned: bool, decode_cache: bool):
    store = sim.immutable
    saved = store.decode_cache
    store.decode_cache = columnar.StripeDecodeCache(256) if decode_cache else None
    mat = sim.materializer(validate_checksum=False)
    store.latency_model = LATENCY
    before = store.stats.snapshot()
    t0 = time.perf_counter()
    n = 0
    for b in batches:
        if planned:
            mat.materialize_batch(b, TENANT)
        else:
            for e in b:
                mat.materialize(e, TENANT)
        n += len(b)
    wall = time.perf_counter() - t0
    store.latency_model = None
    d = store.stats.delta(before)
    store.decode_cache = saved
    return d, n / wall, wall


def run(quick: bool = False) -> List[BenchResult]:
    sim = standard_sim("vlm", users=8, days=2, req_per_day=4) if quick \
        else standard_sim("vlm", users=24, days=6, req_per_day=8)
    batches = _user_bucketed_batches(sim, base=16)

    # per-example baseline: one multi_range_scan per example, no decode cache
    # (the seed read path); planned: one deduped shard-parallel plan per batch
    d_pe, thr_pe, wall_pe = _run(sim, batches, planned=False, decode_cache=False)
    d_pl, thr_pl, wall_pl = _run(sim, batches, planned=True, decode_cache=True)

    decodes_pe = d_pe.stripes_read - d_pe.decode_cache_hits
    decodes_pl = d_pl.stripes_read - d_pl.decode_cache_hits
    return [
        BenchResult(
            "scan_plan/io_work", wall_pl * 1e6 / max(len(batches), 1),
            {
                "per_example_seeks": d_pe.seeks,
                "planned_seeks": d_pl.seeks,
                "per_example_decodes": decodes_pe,
                "planned_decodes": decodes_pl,
                "dedup_hits": d_pl.dedup_hits,
                "decode_cache_hits": d_pl.decode_cache_hits,
                "parallel_shards": d_pl.parallel_shards,
                "fewer_seeks": d_pl.seeks < d_pe.seeks,
                "fewer_decodes": decodes_pl < decodes_pe,
            },
        ),
        BenchResult(
            "scan_plan/throughput", 0.0,
            {
                "per_example_ex_per_s": round(thr_pe, 1),
                "planned_ex_per_s": round(thr_pl, 1),
                "speedup_pct": round(100.0 * (thr_pl - thr_pe) / thr_pe, 1),
                "per_example_bytes": d_pe.bytes_scanned,
                "planned_bytes": d_pl.bytes_scanned,
            },
        ),
    ]


if __name__ == "__main__":
    for r in run():
        print(r.csv())
