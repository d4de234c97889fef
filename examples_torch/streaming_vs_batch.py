"""Bifurcated protocol demo on the PyTorch port (paper §3.2): ONE pipeline
serves both training paradigms.

The same logged traffic is consumed (a) as a live stream by a streaming
trainer, and (b) replayed days later from hourly warehouse partitions by a
batch trainer — the versioned reconstruction yields bit-identical UIH
features and therefore identical BERT4Rec scores on the device, with zero
Fat Row duplication.

Run:  PYTHONPATH=src python examples_torch/streaming_vs_batch.py
          [--device cpu]

Port of ``examples/streaming_vs_batch.py``: the same sim seed, worker,
model and printed lines; ``--device`` is ``cuda`` unless the caller asks
for ``cpu`` (no fallback). The parameters are drawn from a torch generator
seeded 0; ``main`` takes others.
"""
import argparse
import threading

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.projection import TenantProjection
from repro_torch.core.simulation import ProductionSim, SimConfig
from repro_torch.device import resolve_device
from repro_torch.dpp.featurize import FeatureSpec
from repro_torch.dpp.worker import DPPWorker
from repro_torch.models import recsys as R

SEQ_LEN = 32
BATCH = 16
COMPARED = 8               # stream batches replayed and scored

MODEL = R.BERT4RecConfig(name="demo", embed_dim=16, n_blocks=2, n_heads=2,
                         seq_len=SEQ_LEN, item_vocab=2_000,
                         compute_dtype=torch.float32)


def make_worker(sim):
    tenant = TenantProjection("t", seq_len=SEQ_LEN,
                              feature_groups=("core", "sideinfo"),
                              traits_per_group={
                                  "core": ("timestamp", "item_id", "action_type"),
                                  "sideinfo": ("category",)})
    spec = FeatureSpec(seq_len=SEQ_LEN,
                       uih_traits=("item_id", "action_type", "category"))
    return DPPWorker(sim.materializer(validate_checksum=True), tenant, spec,
                     sim.schema)


def build_sim() -> ProductionSim:
    return ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=16, n_items=2_000, days=4,
                               events_per_user_day_mean=40.0, seed=3),
        stripe_len=32, requests_per_user_day=4, seed=3))


def consume_stream(sim: ProductionSim, worker: DPPWorker) -> list:
    """The streaming side: featurize the live stream in batches of
    ``BATCH`` while three days unfold."""
    batches = []

    def consume():
        buf = []
        while True:
            exm = sim.stream.consume()
            if exm is None:
                break
            buf.append(exm)
            if len(buf) == BATCH:
                batches.append(worker.process(buf))
                buf = []

    consumer = threading.Thread(target=consume)
    consumer.start()
    sim.run_days(3, capture_reference=False)
    sim.stream.close()
    consumer.join()
    return batches


def model_batch(b, device) -> dict:
    return {"uih_item_id": torch.as_tensor(b["uih_item_id"].astype(np.int32),
                                           device=device),
            "uih_mask": torch.as_tensor(b["uih_mask"], device=device),
            "cand_item_id": torch.as_tensor(
                b["cand_item_id"].astype(np.int32), device=device)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    return ap.parse_args(argv)


def main(argv=None, params=None) -> dict:
    """Run the demo; ``params`` (optional) replaces the seeded
    initialization. Returns both paradigms' batches and scores."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    sim = build_sim()

    # --- streaming side: consume the live stream as days unfold ---
    worker_s = make_worker(sim)
    stream_batches = consume_stream(sim, worker_s)
    print(f"streaming trainer consumed {len(stream_batches)} batches "
          f"within seconds of logging")

    # --- batch side: replay from the warehouse later (after more compactions) ---
    worker_b = make_worker(sim)
    by_id = {}
    for hour in sim.warehouse.hours():
        for exm in sim.warehouse.read_partition(hour):
            by_id[exm.request_id] = exm

    cfg = MODEL
    if params is None:
        params = R.init_bert4rec(cfg, seed=0, device=device)

    mismatches = 0
    replay_batches, scores = [], []
    for sb in stream_batches[:COMPARED]:
        # find the same examples in the warehouse by (user, ts)
        keys = list(zip(sb["user_id"].tolist(), sb["request_ts"].tolist()))
        replay = [next(e for e in by_id.values()
                       if (e.user_id, e.request_ts) == k) for k in keys]
        bb = worker_b.process(replay)
        replay_batches.append(bb)
        same = all(np.array_equal(sb[k], bb[k]) for k in sb)
        mismatches += 0 if same else 1
        with torch.no_grad():
            s1 = R.bert4rec_forward(params, model_batch(sb, device), cfg)
            s2 = R.bert4rec_forward(params, model_batch(bb, device), cfg)
        if not torch.allclose(s1, s2):
            raise AssertionError("scores diverged between paradigms")
        scores.append((s1.cpu().numpy(), s2.cpu().numpy()))
    print(f"batch replay vs streaming: {mismatches} feature mismatches "
          f"across {min(COMPARED, len(stream_batches))} batches (expect 0)")
    print(f"checksum validations: streaming={worker_s.materializer.stats.checksum_validated},"
          f" batch={worker_b.materializer.stats.checksum_validated}, "
          f"failures={worker_s.materializer.stats.checksum_failures + worker_b.materializer.stats.checksum_failures}")
    return {"mismatches": mismatches, "stream_batches": stream_batches,
            "replay_batches": replay_batches, "scores": scores}


if __name__ == "__main__":
    main()
