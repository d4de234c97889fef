"""Table 1 reproduction: system efficiency of VLM vs Fat Row on a shared
(union) dataset serving 3 model tenants.

Measured mechanisms (same causes as the paper, our scale):
  * primary write bandwidth of the shared training dataset (stream bytes)
  * per-tenant primary read bandwidth (serialized example bytes actually read)
  * per-tenant sequence-lookup bandwidth vs baseline primary read
    (streaming = arrival order, no warehouse clustering; batch = user-bucketed
    warehouse replay with affinity amortization)
  * per-batch data loading latency through a DPP worker with an emulated
    remote-storage cost model: primary store 256 MB/s; immutable single-level
    store 3.4x that (870 MB/s, §5.1) + 50us per batched multi-range scan.

Port of ``benchmarks/table1_system_efficiency.py`` over the port's
``core``, ``dpp`` and ``storage``; no departure. Host-only: nothing reaches
the card.
"""
from __future__ import annotations

import time
from typing import Dict, List

from benchmarks_torch.common import BenchResult, standard_sim
from repro_torch.core.projection import TenantProjection
from repro_torch.dpp.affinity import plan_affine, plan_arrival_order
from repro_torch.dpp.featurize import FeatureSpec
from repro_torch.dpp.worker import DPPWorker

PAPER = {  # Table 1 reference values
    "write_bw_delta_pct": -46.2,
    "model_a": {"read": -70.3, "lookup_stream": +62.7, "lookup_batch": +24.6,
                "latency": +9.7},
    "model_b": {"read": -50.9, "lookup_stream": +16.2, "lookup_batch": +6.5,
                "latency": -26.4},
    "model_c": {"read": -47.7, "lookup_stream": +8.7, "lookup_batch": +3.4,
                "latency": -36.2},
}

TENANTS = {
    "model_a": TenantProjection("model_a", seq_len=360,
                                feature_groups=("core", "engagement", "sideinfo")),
    "model_b": TenantProjection("model_b", seq_len=96,
                                feature_groups=("core", "engagement")),
    "model_c": TenantProjection("model_c", seq_len=24,
                                feature_groups=("core",),
                                traits_per_group={"core": ("timestamp", "item_id")}),
}

BATCH = 16
BW_PRIMARY = 256e6          # bytes/s
BW_LOOKUP = 3.4 * BW_PRIMARY  # single-level immutable store (§5.1: 3.4x)
SCAN_OVERHEAD_S = 2e-5


def _spec_for(tenant: TenantProjection) -> FeatureSpec:
    return FeatureSpec(seq_len=tenant.seq_len,
                       uih_traits=("item_id", "timestamp"))


def _lookup_bytes(sim, tenant, affine: bool) -> int:
    """Immutable-store bytes for one full replay under a given access plan."""
    mat = sim.materializer(validate_checksum=False)
    plan_fn = plan_affine if affine else plan_arrival_order
    plan = plan_fn(sim.examples, sim.immutable.router.n_shards, BATCH)
    before = sim.immutable.stats.snapshot()
    for item in plan.items:
        mat.materialize_batch(item, tenant)
    return sim.immutable.stats.delta(before).bytes_scanned


DECODE_BW = 1e9  # bytes/s, same decode engine on both paths


def _batch_replay(sim, tenant) -> Dict[str, float]:
    """Warehouse (batch-training) replay; per-batch latency is modelled from
    *measured* byte/op counters through a calibrated remote-storage cost model
    (python constant factors would otherwise swamp the comparison):

      t = primary_bytes/BW_p + scans*overhead + lookup_bytes/BW_l
          + decoded_bytes/decode_BW
    """
    mat = sim.materializer(validate_checksum=False)
    mat.window_cache_size = 512       # DPP-worker window cache (block cache)
    worker = DPPWorker(mat, tenant, _spec_for(tenant), sim.schema)
    primary_bytes = 0
    decoded_fat = 0
    n_batches = 0
    before = sim.immutable.stats.snapshot()
    for hour in sim.warehouse.hours():
        for bucket in sim.warehouse.iter_bucketed(hour):
            for lo in range(0, len(bucket), BATCH):
                batch = bucket[lo : lo + BATCH]
                pb = sum(e.payload_bytes(sim.schema) for e in batch)
                primary_bytes += pb
                if batch[0].is_fat:
                    decoded_fat += pb            # fat rows decode their payload
                worker.process(batch)
                n_batches += 1
    d = sim.immutable.stats.delta(before)
    # bytes_decoded credits the store's stripe-decode LRU (the §4.2.3 block
    # cache, on by default) — that is part of the system under test; the Fat
    # Row path decodes its own payload per example and has nothing cacheable
    total_t = (primary_bytes / BW_PRIMARY
               + d.batched_requests * SCAN_OVERHEAD_S
               + d.bytes_scanned / BW_LOOKUP
               + (d.bytes_decoded + decoded_fat) / DECODE_BW)
    return {"latency_s": total_t / max(n_batches, 1),
            "primary_bytes": primary_bytes}


def run(quick: bool = False) -> List[BenchResult]:
    if quick:
        vlm = standard_sim("vlm", users=6, days=2, req_per_day=3)
        fat = standard_sim("fatrow", users=6, days=2, req_per_day=3)
        tenants = {"model_c": TENANTS["model_c"]}
    else:
        vlm = standard_sim("vlm")
        fat = standard_sim("fatrow")
        tenants = TENANTS

    out: List[BenchResult] = []
    write_delta = 100.0 * (vlm.stream.bytes_published
                           - fat.stream.bytes_published) / fat.stream.bytes_published
    out.append(BenchResult(
        "table1/primary_write_bandwidth", 0.0,
        {"ours_pct": round(write_delta, 1),
         "paper_pct": PAPER["write_bw_delta_pct"],
         "vlm_bytes": vlm.stream.bytes_published,
         "fat_bytes": fat.stream.bytes_published},
    ))

    for name, tenant in tenants.items():
        fat_run = _batch_replay(fat, tenant)
        vlm_run = _batch_replay(vlm, tenant)
        lk_stream = _lookup_bytes(vlm, tenant, affine=False)
        lk_batch = _lookup_bytes(vlm, tenant, affine=True)
        base_read = fat_run["primary_bytes"]
        read_delta = 100.0 * (vlm_run["primary_bytes"] - base_read) / base_read
        lat_delta = 100.0 * (vlm_run["latency_s"] - fat_run["latency_s"]) \
            / fat_run["latency_s"]
        out.append(BenchResult(
            f"table1/{name}", vlm_run["latency_s"] * 1e6,
            {
                "read_bw_pct": round(read_delta, 1),
                "paper_read_pct": PAPER[name]["read"],
                "lookup_stream_pct_of_baseline_read":
                    round(100.0 * lk_stream / base_read, 1),
                "paper_lookup_stream": PAPER[name]["lookup_stream"],
                "lookup_batch_pct_of_baseline_read":
                    round(100.0 * lk_batch / base_read, 1),
                "paper_lookup_batch": PAPER[name]["lookup_batch"],
                "latency_delta_pct": round(lat_delta, 1),
                "paper_latency_pct": PAPER[name]["latency"],
            },
        ))
    return out


if __name__ == "__main__":
    for r in run():
        print(r.csv())
