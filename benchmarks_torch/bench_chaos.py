"""Resilience overhead: the fault-tolerant data plane under a seeded 1%-fault
FaultPlan vs the fault-free baseline (§10).

Three measurements over the same warehouse-replay feed (ordered placement,
self-healing workers):

  * ``chaos_clean``     — fault-free rows/s (the resilience machinery is on,
                          but nothing fires: its standing cost);
  * ``chaos_faulty_1pct`` — rows/s with ~1% of store scans failing (IOError /
                          decode corruption / worker crash mix), plus the
                          recovery counters and the mean recovery latency
                          (extra wall per injected fault);
  * ``chaos_equivalence`` — asserts the faulty run's batches are
                          byte-identical to the clean run's (the §10
                          guarantee this benchmark exists to price).

Port of ``benchmarks/bench_chaos.py`` over the port's ``open_feed`` and
``testing`` harness. One departure: ``run`` takes ``device`` (``cuda``
unless the caller asks for ``cpu``; without a card ``cuda`` is an error,
never a fallback) and hands it to ``open_feed``. With ``prefetch_depth=0``,
as in the reference, the feed has no device stage: the batches stay on the
host and nothing reaches the card.
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks_torch.common import BenchResult, standard_sim
from repro_torch.core.projection import TenantProjection
from repro_torch.data import DatasetSpec, WarehouseSource, open_feed
from repro_torch.device import resolve_device
from repro_torch.dpp.featurize import FeatureSpec
from repro_torch.testing import FaultPlan, FaultSpec, wrap_sim

RATES = {"scan_ioerror": 0.004, "decode_corruption": 0.003,
         "worker_crash": 0.003}   # ~1% of scans fault in total


def _spec(seq_len: int) -> DatasetSpec:
    tenant = TenantProjection(
        "chaos", seq_len, ("core",),
        traits_per_group={"core": ("timestamp", "item_id", "action_type")})
    return DatasetSpec(
        tenant=tenant,
        source=WarehouseSource(),
        features=FeatureSpec(seq_len=seq_len,
                             uih_traits=("item_id", "action_type")),
        batch_size=32, base_batch_size=8, n_workers=2, prefetch_depth=0,
        window_cache_size=0,    # every item scans: the fault rate is honest
    )


def _run(spec, sim, device):
    feed = open_feed(spec, sim, device=device)
    t0 = time.perf_counter()
    batches = list(feed)
    feed.join()
    wall = time.perf_counter() - t0
    rows = sum(len(b["user_id"]) for b in batches)
    return batches, rows, wall, feed.stats()


def run(quick: bool = False, device: str = "cuda"):
    device = resolve_device(device)
    if quick:
        sim = standard_sim("vlm", users=8, days=2, req_per_day=3,
                           events_mean=20.0)
    else:
        sim = standard_sim("vlm")
    spec = _spec(32 if quick else 64)

    clean_batches, rows, wall_clean, _ = _run(spec, sim, device)

    if quick:
        # the tiny quick config has too few scans for a 1% rate to reliably
        # land a fault: pin two so the recovery path is still smoke-tested
        plan = FaultPlan([FaultSpec("worker_crash", 1),
                          FaultSpec("scan_ioerror", 3)])
    else:
        # seeded 1%-fault plan over a horizon above the scan count
        plan = FaultPlan.seeded(42, RATES,
                                max(64, rows // spec.base_batch_size * 4))
    faulty_batches, rows_f, wall_f, st = _run(spec, wrap_sim(sim, plan),
                                              device)

    identical = len(clean_batches) == len(faulty_batches) and all(
        all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(clean_batches, faulty_batches))
    assert identical, (
        "faulty run diverged from the fault-free run — the §10 byte-identical "
        "recovery guarantee is broken")
    n_faults = plan.n_fired
    recovery_ms = (max(0.0, wall_f - wall_clean) / n_faults * 1e3
                   if n_faults else 0.0)

    return [
        BenchResult("chaos_clean", wall_clean / max(rows, 1) * 1e6, {
            "rows": rows,
            "rows_per_s": round(rows / wall_clean, 1),
        }),
        BenchResult("chaos_faulty_1pct", wall_f / max(rows_f, 1) * 1e6, {
            "rows": rows_f,
            "rows_per_s": round(rows_f / wall_f, 1),
            "faults_injected": n_faults,
            "worker_restarts": st.workers.worker_restarts,
            "items_requeued": st.workers.items_requeued,
            "overhead_pct": round(100.0 * (wall_f - wall_clean)
                                  / max(wall_clean, 1e-9), 1),
            "mean_recovery_ms": round(recovery_ms, 2),
        }),
        BenchResult("chaos_equivalence", 0.0, {
            "byte_identical": bool(identical),
        }),
    ]


if __name__ == "__main__":
    for r in run():
        print(r.csv())
