"""Quickstart on the PyTorch port: the versioned late materialization
protocol in ~60 lines.

Walks the full lifecycle on synthetic traffic:
  events -> mutable tier (blind writes) -> daily compaction -> immutable tier
  -> inference-time snapshot (mutable slice + O(1) version metadata)
  -> training-time time-travel reconstruction -> O2O verification.

Run:  PYTHONPATH=src python examples_torch/quickstart.py

Port of ``examples/quickstart.py``, and host-only as it is: ``core``,
``data`` and an ``open_feed`` without a device stage (the spec's
``prefetch_depth`` leaves it out), so it takes no ``--device`` and touches
no card. Its output is the reference's, line for line.
"""
from repro_torch.core import events as ev
from repro_torch.core.consistency import batches_equal, future_leakage_count
from repro_torch.core.projection import TenantProjection
from repro_torch.core.simulation import ProductionSim, SimConfig
from repro_torch.data import DatasetSpec, SimSource, open_feed


def main() -> None:
    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=4, n_items=2_000, days=5,
                               events_per_user_day_mean=50.0, seed=0),
        stripe_len=32,
        requests_per_user_day=3,
    ))
    sim.run_days(4)
    print(f"logged {len(sim.examples)} training examples over 4 days")

    exm = max(sim.examples, key=lambda e: e.version.seq_len)
    ref = sim.references[sim.examples.index(exm)]
    print(f"\npicked request {exm.request_id} of user {exm.user_id}:")
    print(f"  immutable window: [{exm.version.start_ts}, {exm.version.end_ts}]"
          f" seq_len={exm.version.seq_len} checksum={exm.version.checksum:#x}")
    print(f"  mutable slice: {ev.batch_len(exm.mutable_uih)} recent events")
    print(f"  example payload: {exm.payload_bytes(sim.schema)} B "
          f"(vs {sum(v.nbytes for v in ref.values())} B raw fat row)")

    # --- time-travel reconstruction (checksum-validated) ---
    mat = sim.materializer(validate_checksum=True)
    uih = mat.materialize(exm)
    print(f"\nreconstructed {ev.batch_len(uih)} events at training time")
    print(f"  O2O-exact vs inference state: {batches_equal(uih, ref)}")
    print(f"  future leakage events:       {future_leakage_count(uih, exm.request_ts)}")
    print(f"  checksum validations:        {mat.stats.checksum_validated}"
          f" (failures: {mat.stats.checksum_failures})")

    # --- multi-tenant projection pushdown ---
    short = TenantProjection("retrieval", seq_len=16, feature_groups=("core",),
                             traits_per_group={"core": ("timestamp", "item_id")})
    before = sim.immutable.stats.snapshot()
    small = mat.materialize(exm, short)
    d = sim.immutable.stats.delta(before)
    print(f"\nshort-sequence tenant fetched {ev.batch_len(small)} events, "
          f"traits={sorted(small.keys())}")
    print(f"  bytes scanned: {d.bytes_scanned} (projection pushdown), "
          f"stripes read: {d.stripes_read}, seeks: {d.seeks}")

    # --- the declarative read path: DatasetSpec -> open_feed -> Feed ---
    # one frozen spec describes the whole pipeline (source, projection,
    # consistency, batching); the compiler wires the data plane
    ds = DatasetSpec(tenant=short, source=SimSource(epochs=1),
                     consistency="audit", batch_size=8, base_batch_size=4,
                     n_workers=1)
    with open_feed(ds, sim) as feed:
        batch = next(iter(feed))
        print(f"\nopen_feed({ds.tenant.name!r}): first full batch "
              f"{len(batch['uih_len'])} rows, "
              f"uih_item_id {batch['uih_item_id'].shape}")
        for _ in feed:        # drain so the pool exits, then close via `with`
            pass
    print(f"  feed drained: {feed.drained}; "
          f"worker examples: {feed.stats().workers.examples}")


if __name__ == "__main__":
    main()
