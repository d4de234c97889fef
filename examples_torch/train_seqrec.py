"""End-to-end training driver on the PyTorch port: the complete stack, one
process.

  synthetic traffic -> mutable/immutable tiers -> VLM snapshots -> warehouse
  -> declarative read path: DatasetSpec -> open_feed (elastic DPP pool,
     vectorized featurize, slot-based rebatching, device prefetch)
  -> DLRM-UIH trainer (AdamW, grad accumulation, crash-safe checkpointing).

Run:  PYTHONPATH=src python examples_torch/train_seqrec.py [--steps 200]
          [--resume] [--no-prefetch] [--device cpu] [--config full]

Port of ``examples/train_seqrec.py``: the same flags, defaults, sim seed,
spec and printed lines. ``--device`` is ``cuda`` unless the caller asks for
``cpu``; without a card ``cuda`` is an error, never a fallback. ``--config
example`` is the reference's CPU-sized model; ``--config full`` is
``repro_torch.configs.dlrm_uih.FULL`` (1,536,883,841 float32 parameters at
seq_len 2048), the same driver at the paper's width. Its sequence length
sets the feed's. A FULL checkpoint is ~18 GB: run it with fewer than 50
steps to write none. On a card the run ends with the device's name, the
rate of its steps after the first two (their set-up excluded) and its peak
allocated bytes.

The model prep runs on the host (as the reference's ``prep_fn``), which
turns device materialization off; with prefetch the ``DevicePrefetcher``
copies the prepped batch to the device once, and with ``--no-prefetch``
``prep`` puts it there itself.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import dlrm_uih
from repro_torch.core import events as ev
from repro_torch.core.projection import TenantProjection
from repro_torch.core.simulation import ProductionSim, SimConfig
from repro_torch.data import DatasetSpec, SimSource, open_feed
from repro_torch.device import resolve_device
from repro_torch.dpp.elastic import ElasticConfig, ElasticController
from repro_torch.dpp.featurize import FeatureSpec
from repro_torch.models import recsys as R
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import Trainer, TrainerConfig

SEQ_LEN = 48
BATCH = 32
BASE_BATCH = 8
CKPT_DIR = "/tmp/repro_torch_seqrec_ckpt"   # never the reference's JAX one

CONFIGS = {
    "example": R.DLRMUIHConfig(
        name="seqrec", seq_len=SEQ_LEN, d_seq=32, n_seq_layers=2, n_heads=4,
        n_dense=4, n_sparse=2, embed_dim=16, item_vocab=4_096,
        field_vocab=4_096, compute_dtype=torch.float32, remat=False),
    "full": dlrm_uih.FULL,
}


def build_sim(seed: int = 0) -> ProductionSim:
    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=32, n_items=4_000, days=7,
                               events_per_user_day_mean=40.0, seed=seed),
        stripe_len=32, requests_per_user_day=6, seed=seed,
    ))
    sim.run_days(6, capture_reference=False)
    return sim


def dataset_spec(steps: int, prefetch: bool,
                 seq_len: int = SEQ_LEN) -> DatasetSpec:
    """The whole feed, declaratively: tenant projection + source + knobs."""
    tenant = TenantProjection(
        "dlrm-uih", seq_len=seq_len,
        feature_groups=("core", "sideinfo"),
        traits_per_group={"core": ("timestamp", "item_id", "action_type"),
                          "sideinfo": ("category",)})
    features = FeatureSpec(seq_len=seq_len,
                           uih_traits=("item_id", "action_type", "category"),
                           candidate_fields=("item_id",),
                           label_fields=("click",))
    return DatasetSpec(
        tenant=tenant,
        source=SimSource(min_rows=steps * BATCH + BATCH),  # cover the run
        batch_size=BATCH, base_batch_size=BASE_BATCH,
        prefetch_depth=2 if prefetch else 0,
        n_workers=2, window_cache_size=256, features=features,
    )


def prep(b, cfg, device=None):
    """The model's inputs from a host batch: numpy arrays (the reference's
    bytes), or tensors on ``device`` when one is given. The sparse fields
    alternate user and candidate ids, ``cfg.n_dense`` copies of the
    history's fill make the dense features."""
    sources = (b["user_id"], b["cand_item_id"])
    out = {
        "uih_item_id": (b["uih_item_id"] % cfg.item_vocab).astype(np.int32),
        "uih_action_type": (b["uih_action_type"] % 16).astype(np.int32),
        "uih_mask": b["uih_mask"],
        "cand_item_id": (b["cand_item_id"] % cfg.item_vocab).astype(np.int32),
        "sparse_ids": np.stack([sources[i % 2] % cfg.field_vocab
                                for i in range(cfg.n_sparse)],
                               1).astype(np.int32),
        "dense": np.stack([b["uih_mask"].sum(1)] * cfg.n_dense,
                          1).astype(np.float32) / cfg.seq_len,
        "label": b["label_click"].astype(np.float32),
    }
    if device is None:
        return out
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="host-only feed (seed-style sync device transfer)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--config", choices=sorted(CONFIGS), default="example",
                    help="example: the CPU-sized model; full: "
                         "configs.dlrm_uih.FULL")
    return ap.parse_args(argv)


def train(args: argparse.Namespace, cfg: R.DLRMUIHConfig, params,
          sim: ProductionSim = None) -> Trainer:
    """Resume if asked, then train ``params`` from the feed to
    ``args.steps`` and print the reference's summary."""
    device = params["item_table"].device
    n_params = sum(p.numel() for p in params.parameters())
    print(f"DLRM-UIH: {n_params/1e6:.2f}M params, seq_len={cfg.seq_len}")

    sim = build_sim() if sim is None else sim
    trainer = Trainer(
        lambda p, b: R.dlrm_uih_loss(p, b, cfg), params,
        TrainerConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=20,
                                      total_steps=args.steps),
                      ckpt_dir=args.ckpt_dir, ckpt_every=50, grad_accum=2,
                      log_every=20))
    if args.resume and trainer.try_resume():
        print(f"resumed from step {trainer.step}")
    ends = []                  # each step's end: the steady-state rate
    run_step = trainer.run_step

    def timed_step(batch):
        out = run_step(batch)  # float() of the loss waits for the device
        ends.append(time.perf_counter())
        return out

    trainer.run_step = timed_step

    # ONE declarative call replaces the old hand-wired client/pool/prefetcher
    prefetch = not args.no_prefetch
    to = None if prefetch else device
    feed = open_feed(
        dataset_spec(args.steps, prefetch=prefetch, seq_len=cfg.seq_len), sim,
        device=device, prep_fn=lambda b: prep(b, cfg, to),
        controller=ElasticController(ElasticConfig(min_workers=1,
                                                   max_workers=8)))
    t0 = time.perf_counter()
    trainer.fit(feed, max_steps=args.steps)
    dt = time.perf_counter() - t0
    feed.close(timeout=10.0)   # drain leftover items so workers exit cleanly
    first = np.mean([h["loss"] for h in trainer.history[:10]])
    last = np.mean([h["loss"] for h in trainer.history[-10:]])
    st = feed.stats()
    cs, ws = st.client, st.workers
    print(f"\ntrained {trainer.step} steps in {dt:.1f}s "
          f"({trainer.step / dt:.1f} steps/s)")
    print(f"loss {first:.4f} -> {last:.4f}")
    print(f"feed: starvation {cs.starvation_pct:.1f}% "
          f"(host {cs.starved_host_s*1e3:.0f}ms, h2d {cs.starved_h2d_s*1e3:.0f}ms), "
          f"h2d total {cs.h2d_time_s*1e3:.0f}ms, slot reuses {cs.slot_reuses}, "
          f"peak workers {st.peak_workers}, worker waste {ws.waste_pct:.1f}%")
    print(f"featurize {ws.featurize_time_s*1e3:.0f}ms over "
          f"{ws.examples} examples ({ws.base_batches} base batches)")
    if device.type == "cuda":
        steady = (f"; steps 3-{len(ends)} of this run "
                  f"{(len(ends) - 2) / (ends[-1] - ends[1]):.3f} steps/s"
                  if len(ends) > 3 else "")
        print(f"device: {torch.cuda.get_device_name(device)}, "
              f"{len(trainer.history)} steps in this run, "
              f"{trainer.step - len(trainer.history)} before it{steady}; "
              f"peak {torch.cuda.max_memory_allocated(device)} B allocated")
    return trainer


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = CONFIGS[args.config]
    params = R.init_dlrm_uih(cfg, seed=0, device=device)
    return train(args, cfg, params)


if __name__ == "__main__":
    main()
