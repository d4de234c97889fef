"""§4.2.3 data-affinity: user bucketing + symmetric sharding for batch
training. Paper: ~60% lookup-bandwidth reduction, +28% per-worker throughput.

Port of ``benchmarks/bench_affinity.py`` over the port's ``dpp.affinity``
and ``DPPWorker``; no departure. Host-only: nothing reaches the card.
"""
from __future__ import annotations

import time
from typing import List

from benchmarks_torch.common import BenchResult, standard_sim
from repro_torch.core.projection import TenantProjection
from repro_torch.dpp.affinity import plan_affine, plan_arrival_order
from repro_torch.dpp.featurize import FeatureSpec
from repro_torch.dpp.worker import DPPWorker

TENANT = TenantProjection("t", seq_len=256,
                          feature_groups=("core", "engagement"))
SPEC = FeatureSpec(seq_len=256, uih_traits=("item_id",))


def _run_plan(sim, plan, emulate_io: bool):
    mat = sim.materializer(validate_checksum=False)
    if emulate_io:
        # remote-storage latency model: per-seek + per-byte + per-shard-hop
        mat.immutable.latency_model = (
            lambda seeks, nbytes, fanout:
            2e-4 * seeks + nbytes / 2e9 + 5e-4 * max(fanout - 1, 0))
    worker = DPPWorker(mat, TENANT, SPEC, sim.schema)
    before = sim.immutable.stats.snapshot()
    t0 = time.perf_counter()
    for item in plan.items:
        worker.process(item)
    wall = time.perf_counter() - t0
    mat.immutable.latency_model = None
    d = sim.immutable.stats.delta(before)
    n = sum(len(i) for i in plan.items)
    return d, n / wall, wall


def run(quick: bool = False) -> List[BenchResult]:
    sim = standard_sim("vlm", users=8, days=2, req_per_day=3) if quick \
        else standard_sim("vlm", users=32, days=6, req_per_day=6)
    n_shards = sim.immutable.router.n_shards
    affine = plan_affine(sim.examples, n_shards, 16)
    arrival = plan_arrival_order(sim.examples, n_shards, 16)

    d_arr, thr_arr, _ = _run_plan(sim, arrival, emulate_io=True)
    d_aff, thr_aff, _ = _run_plan(sim, affine, emulate_io=True)

    bw_delta = 100.0 * (d_aff.bytes_scanned - d_arr.bytes_scanned) \
        / d_arr.bytes_scanned
    thr_delta = 100.0 * (thr_aff - thr_arr) / thr_arr
    return [
        BenchResult(
            "affinity/lookup_bandwidth", 0.0,
            {"ours_pct": round(bw_delta, 1), "paper_pct": -60.0,
             "arrival_bytes": d_arr.bytes_scanned,
             "affine_bytes": d_aff.bytes_scanned,
             "arrival_fanout": round(arrival.expected_fanout, 2),
             "affine_fanout": round(affine.expected_fanout, 2)},
        ),
        BenchResult(
            "affinity/worker_throughput", 0.0,
            {"ours_pct": round(thr_delta, 1), "paper_pct": +28.0,
             "arrival_ex_per_s": round(thr_arr, 1),
             "affine_ex_per_s": round(thr_aff, 1)},
        ),
    ]


if __name__ == "__main__":
    for r in run():
        print(r.csv())
