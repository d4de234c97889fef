"""Multi-tenant co-scan benchmark (Table 1's amplification elimination).

N model tenants (the Table 1 projections: long/mid/short sequence, nested
feature groups) train over the SAME union dataset. The baseline issues one
solo scan pass per tenant; the ``MultiTenantPlanner`` computes the per-window
union projection and issues ONE co-scan, carving per-tenant views host-side.

Measured for N ∈ {1, 2, 3} tenants over the same affinity-planned replay:

  * immutable-store bytes read (``IOStats.bytes_scanned``): co-scan vs the
    sum of solo scans — the co-scan must be strictly cheaper for N >= 2;
  * stripe decodes: co-scan decodes each window's stripes once, solos decode
    them once PER TENANT (the decode LRU is disabled so the comparison is
    raw work, not cache luck);
  * materialization throughput (rows/s across all tenant outputs);
  * the planner's own ``TenantShareStats`` accounting
    (``bytes_saved_vs_solo`` must agree in sign with the measured delta).

Per-tenant outputs are asserted byte-identical (keys, dtypes, values) to the
solo path — the saving is free, not lossy.

Port of ``benchmarks/bench_multitenant.py`` over the port's
``MultiTenantPlanner`` and ``Materializer``; no departure. Host-only:
nothing reaches the card.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmarks_torch.common import BenchResult, standard_sim
from repro_torch.core.materialize import Materializer
from repro_torch.core.projection import TenantProjection
from repro_torch.data import MultiTenantPlanner
from repro_torch.dpp.affinity import plan_affine

TENANTS = {  # the Table 1 evaluation tenants at benchmark scale
    "model_a": TenantProjection("model_a", seq_len=360,
                                feature_groups=("core", "engagement",
                                                "sideinfo")),
    "model_b": TenantProjection("model_b", seq_len=96,
                                feature_groups=("core", "engagement")),
    "model_c": TenantProjection("model_c", seq_len=24,
                                feature_groups=("core",),
                                traits_per_group={"core": ("timestamp",
                                                           "item_id")}),
}

BATCH = 16


def _assert_identical(co: List[dict], solo: List[dict], name: str) -> None:
    assert len(co) == len(solo), name
    for a, b in zip(co, solo):
        assert list(a.keys()) == list(b.keys()), (name, sorted(a), sorted(b))
        for k in a:
            assert a[k].dtype == b[k].dtype, (name, k)
            assert np.array_equal(a[k], b[k]), (name, k)


def run(quick: bool = False) -> List[BenchResult]:
    if quick:
        sim = standard_sim("vlm", users=6, days=2, req_per_day=3)
    else:
        sim = standard_sim("vlm")
    # raw decode accounting: every stripe read is a decode, so "stripe
    # decodes" compares WORK, not decode-LRU hit luck
    sim.immutable.decode_cache = None
    n_shards = sim.immutable.router.n_shards
    items = plan_affine(sim.examples, n_shards, BATCH).items
    n_examples = len(sim.examples)
    store = sim.immutable

    out: List[BenchResult] = []
    all_tenants = list(TENANTS.values())
    for n in range(1, len(all_tenants) + 1):
        tenants = all_tenants[:n]

        # -- solo baseline: one full scan pass per tenant -------------------
        solo_out: Dict[str, List[dict]] = {}
        before = store.stats.snapshot()
        t0 = time.perf_counter()
        for t in tenants:
            mat = Materializer(store, sim.schema)   # window cache off: raw IO
            outs: List[dict] = []
            for item in items:
                outs.extend(mat.materialize_batch(item, t))
            solo_out[t.name] = outs
        solo_s = time.perf_counter() - t0
        d_solo = store.stats.delta(before)

        # -- union co-scan: ONE pass serves every tenant --------------------
        planner = MultiTenantPlanner(tenants, store, sim.schema)
        co_out: Dict[str, List[dict]] = {t.name: [] for t in tenants}
        before = store.stats.snapshot()
        t0 = time.perf_counter()
        for item in items:
            views = planner.materialize_batch(item)
            for name, batches in views.items():
                co_out[name].extend(batches)
        co_s = time.perf_counter() - t0
        d_co = store.stats.delta(before)

        for t in tenants:  # the saving must be lossless
            _assert_identical(co_out[t.name], solo_out[t.name], t.name)

        share = planner.share_stats
        rows = n_examples * n
        out.append(BenchResult(
            f"multitenant/n{n}_tenants", co_s / max(len(items), 1) * 1e6,
            {
                "tenants": n,
                "co_bytes": d_co.bytes_scanned,
                "solo_bytes_sum": d_solo.bytes_scanned,
                "bytes_saved_pct": round(
                    100.0 * (d_solo.bytes_scanned - d_co.bytes_scanned)
                    / max(d_solo.bytes_scanned, 1), 1),
                "co_stripe_decodes": d_co.stripes_read,
                "solo_stripe_decodes": d_solo.stripes_read,
                "co_rows_per_s": round(rows / max(co_s, 1e-9)),
                "solo_rows_per_s": round(rows / max(solo_s, 1e-9)),
                "share_bytes_saved_vs_solo": share.bytes_saved_vs_solo,
                "share_union_overfetch": share.union_overfetch_bytes,
                "co_scan_windows": share.co_scan_windows,
                "outputs_identical": True,   # asserted above
            },
        ))
    return out


if __name__ == "__main__":
    for r in run():
        print(r.csv())
