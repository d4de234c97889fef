"""§4.2.2 pipelined I/O prefetching: overlap the immutable lookup for batch N
with the probe-side read for batch N+1. Paper: ~10% per-worker throughput.

Port of ``benchmarks/bench_prefetch.py`` over the port's ``DPPWorker``; no
departure. Host-only: nothing reaches the card.
"""
from __future__ import annotations

from typing import List

from benchmarks_torch.common import BenchResult, standard_sim
from repro_torch.core.projection import TenantProjection
from repro_torch.dpp.featurize import FeatureSpec
from repro_torch.dpp.worker import DPPWorker, probe_from_list

TENANT = TenantProjection("t", seq_len=256, feature_groups=("core",))
SPEC = FeatureSpec(seq_len=256, uih_traits=("item_id",))
DELAY = 0.004  # comparable probe/lookup latencies (paper's assumption)


def _worker(sim, delay=DELAY):
    mat = sim.materializer(validate_checksum=False)
    mat.immutable.latency_model = lambda seeks, nbytes, fanout: delay
    return DPPWorker(mat, TENANT, SPEC, sim.schema, probe_latency_s=delay)


def run(quick: bool = False) -> List[BenchResult]:
    if quick:
        sim = standard_sim("vlm", users=8, days=2, req_per_day=3)
        examples, delay = sim.examples[:32], 0.001
    else:
        sim = standard_sim("vlm", users=32, days=5, req_per_day=5)
        examples, delay = sim.examples[:320], DELAY

    w_serial = _worker(sim, delay)
    n_serial = sum(1 for _ in w_serial.run_serial(probe_from_list(examples, 16)))
    w_piped = _worker(sim, delay)
    n_piped = sum(1 for _ in w_piped.run_pipelined(probe_from_list(examples, 16)))
    assert n_serial == n_piped

    thr_serial = len(examples) / w_serial.stats.total_time_s
    thr_piped = len(examples) / w_piped.stats.total_time_s
    delta = 100.0 * (thr_piped - thr_serial) / thr_serial
    return [BenchResult(
        "prefetch/pipelined_throughput",
        1e6 * w_piped.stats.total_time_s / n_piped,
        {"ours_pct": round(delta, 1), "paper_pct": +10.0,
         "serial_ex_per_s": round(thr_serial, 1),
         "pipelined_ex_per_s": round(thr_piped, 1),
         "serial_waste_pct": round(w_serial.stats.waste_pct, 1),
         "pipelined_waste_pct": round(w_piped.stats.waste_pct, 1)},
    )]


if __name__ == "__main__":
    for r in run():
        print(r.csv())
