#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. It builds every CUDA kernel from ``src/repro_torch``
into ``build/``, holds each kernel against its plain PyTorch version on the
card, then trains the full-width DLRM-UIH (``configs/dlrm_uih.FULL``) for a
few AdamW steps from device-materialized batches:

  ProductionSim -> open_feed(device_materialize=True, prefetch_depth=2)
  -> compact jagged payloads -> DeviceMaterializer (CUDA fused_densify)
  -> Trainer.fit

The last ``PROFILE_STEPS`` steps of that run are traced with
``torch.profiler`` (device activity only) and every step is split by CUDA
events into gradients and AdamW, so the step's breakdown comes from the main
path's own batches.

Each phase prints one line and raises on failure; nothing falls back to the
CPU. The line before the last is the card's name and power limit, the line
before that a JSON object with one entry per kernel (launches on the main
path, error against the plain version, times and bound), and the last line
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
DEVICE = "cuda"
BATCH = 32                 # rows per trainer batch (two microbatches of 16)
STEPS = 20
PROFILE_STEPS = 5          # the main path's last steps, traced by the profiler
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 bandwidth, NVIDIA data sheet
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(SMI_QUERY, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 200, name: str = "") -> float:
    """Mean device time per call of the kernels ``fn`` launches whose name
    contains ``name`` (all of them for ""), read from a ``torch.profiler``
    trace of ``iters`` calls: kernel durations only, no host dispatch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.key]
    require(bool(found), f"the profiler saw no device kernel {name!r}")
    if name:
        n = sum(e.count for e in found)
        require(n == iters, f"{n} {name} kernels traced for {iters} calls")
    return sum(e.self_device_time_total for e in found) / 1e3 / iters


# ---------------------------------------------------------------------------
# phase 3: fused_densify against its plain version on the card
# ---------------------------------------------------------------------------

def densify_case(rng, b, seq_len, lens, ts0=None, float_lane=False):
    """A packed (arena, offsets, bases, ts_col) case from numpy, laid out as
    the main path's payloads: int64 item ids, two int32 lanes, optionally a
    float32 lane, and a delta-encoded timestamp column from ``ts0`` on."""
    import numpy as np

    from repro_torch.kernels.fused import ops

    offs = np.zeros(b + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    n = int(offs[-1])
    vals = {"item_id": rng.integers(0, 10_000_000, n).astype(np.int64),
            "action_type": rng.integers(0, 16, n).astype(np.int32),
            "category": rng.integers(0, 1_000, n).astype(np.int32)}
    if float_lane:
        special = np.array([-0.0, np.inf, -np.inf, np.nan, 1e-42, -1e-42],
                           np.float32)
        vals["score"] = np.resize(special, n)
    bases, ts_col = None, -1
    if ts0 is not None:
        ts = np.concatenate([ts0 + np.sort(rng.integers(0, 10**9, int(k)))
                             for k in lens]).astype(np.int64)
        vals["timestamp"], bases = ops.ts_delta_encode(ts, offs)
        ts_col = list(vals).index("timestamp")
    arena, _ = ops.pack_arena(vals)
    return arena, offs.astype(np.int32), bases, ts_col


def kernel_vs_plain(case, seq_len):
    """Run the kernel and the plain version on the same card tensors; both
    outputs must be identical. Returns (max_abs_err, card tensors)."""
    import torch

    from repro_torch.kernels.fused import ops

    arena, offs, bases, ts_col = case
    dev = torch.device("cuda")
    args = (torch.from_numpy(arena).to(dev), torch.from_numpy(offs).to(dev),
            seq_len, None if bases is None else torch.from_numpy(bases).to(dev),
            ts_col)
    got = ops.fused_densify(*args)
    want = ops.fused_densify_ref(*args)
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        require((g is None) == (w is None), "kernel/plain outputs differ")
        if g is None:
            continue
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"kernel output {g.shape}/{g.dtype} vs plain "
                f"{w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    require(err == 0, f"fused_densify disagrees with its plain version: "
                      f"max abs err {err}")
    return err, args


def densify_phase():
    import numpy as np
    import torch

    from repro_torch.kernels.fused import ops

    L, b = 2048, BATCH
    rng = np.random.default_rng(SEED)
    # the main path's shape: B=32, L=2048, 4 traits, timestamp column on;
    # rows from empty through over-length, timestamps past 2^31
    lens = rng.integers(0, 2 * L, b)
    lens[:3] = (0, L, 3 * L)
    main = densify_case(rng, b, L, lens, ts0=3_000_000_000)
    err, args = kernel_vs_plain(main, L)
    edge = {   # name -> (case, seq_len)
        "over-length rows": (densify_case(
            rng, 8, 64, [65, 200, 64, 1, 0, 130, 64, 500]), 64),
        "empty batch": (densify_case(rng, 0, 64, []), 64),
        "all-empty rows": (densify_case(rng, 6, 64, [0] * 6, ts0=5), 64),
        "float32 bit-cast lane": (densify_case(
            rng, 5, 16, [3, 16, 0, 7, 9], float_lane=True), 16),
        "timestamps above 2^31": (densify_case(
            rng, 7, 300, [300, 1, 0, 299, 12, 300, 77], ts0=2**31 + 12_345),
            300),
        "drift trait, own offsets": (densify_case(
            rng, 6, 32, [31, 0, 32, 5, 2, 9]), 32),
    }
    for case, seq_len in edge.values():
        err = max(err, kernel_vs_plain(case, seq_len)[0])
    say("kernel", f"fused_densify == plain version at B={b} L={L} T=4 "
                  f"(ts on) and on {len(edge)} edge cases: "
                  f"{', '.join(edge)}; max_abs_err {err}")

    ms = cuda_ms(lambda: ops.fused_densify(*args))
    plain_ms = cuda_ms(lambda: ops.fused_densify_ref(*args), iters=50)
    dev_ms = device_ms(lambda: ops.fused_densify(*args),
                       name="fused_densify_kernel")
    plain_dev_ms = device_ms(lambda: ops.fused_densify_ref(*args), iters=50)
    kept = int(np.minimum(lens, L).sum())
    t = main[0].shape[1]
    nbytes = (kept * t * 4 + (b + 1) * 4 + b * 8      # arena rows read, offsets, bases
              + b * L * t * 4 + b * L * 8)           # int32 block + int64 timestamps
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    say("kernel", f"fused_densify {ms:.6f} ms a call (device only "
                  f"{dev_ms:.6f} ms), plain version {plain_ms:.6f} ms a call "
                  f"(device only {plain_dev_ms:.6f} ms), bound {bound_ms:.6f} "
                  f"ms ({nbytes} bytes at 3.35 TB/s; bound by bytes); "
                  f"library_ms: null (no single PyTorch call computes this "
                  f"function)")
    return {"name": "fused_densify", "route": "cuda",
            "source": "src/repro_torch/kernels/fused/csrc/fused_densify.cu",
            "replaces": "src/repro/kernels/fused/fused.py:59",
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "plain_device_ms": plain_dev_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


# ---------------------------------------------------------------------------
# phase 4: the main path — FULL DLRM-UIH trained from device-materialized
# batches
# ---------------------------------------------------------------------------

L_MAIN = 2048
TRAITS = ("item_id", "action_type", "category", "timestamp")


def build_sim():
    """32 users whose histories reach seq_len. The lookback is 24 days: the
    timestamp codec carries window-relative offsets in int32 milliseconds,
    so a window may span at most 2^31 ms (24.8 days)."""
    from repro_torch.core import events as ev
    from repro_torch.core.simulation import ProductionSim, SimConfig

    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=32, n_items=100_000, days=30,
                               events_per_user_day_mean=80, seed=SEED),
        stripe_len=256, lookback_ms=24 * ev.MS_PER_DAY, seed=SEED))
    sim.run_days(29, capture_reference=False)
    return sim


def feed_spec():
    """The tenant and features of examples/train_seqrec.py at L=2048, with
    the timestamp trait added so every batch runs the in-kernel decode."""
    from repro_torch.core.projection import TenantProjection
    from repro_torch.data import DatasetSpec, SimSource
    from repro_torch.dpp.featurize import FeatureSpec

    return DatasetSpec(
        tenant=TenantProjection(
            "dlrm-uih", seq_len=L_MAIN, feature_groups=("core", "sideinfo"),
            traits_per_group={"core": ("timestamp", "item_id", "action_type"),
                              "sideinfo": ("category",)}),
        source=SimSource(min_rows=(STEPS + 4) * BATCH),
        batch_size=BATCH, base_batch_size=8, prefetch_depth=2, n_workers=4,
        device_materialize=True,
        features=FeatureSpec(seq_len=L_MAIN, uih_traits=TRAITS,
                             candidate_fields=("item_id",),
                             label_fields=("click",)))


def recording_materializer(base):
    """Wrap the feed's DeviceMaterializer to keep every payload it is given
    and the first device batch. It does nothing else in the transfer thread,
    so the H2D clock times the materializer alone; the checks run after
    training."""

    class Recording(type(base)):
        first = None

        def __call__(self, payload):
            out = super().__call__(payload)
            if self.first is None:
                self.first = out
            self.payloads.append(payload)
            return out

    rec = Recording(ts_trait=base.ts_trait, device=base.device)
    rec.payloads = []
    return rec


def launches_called_for(payload) -> int:
    """Kernel launches a payload calls for: one for its shared-plan trait
    group and one per trait with its own offsets, each unless that arena is
    empty."""
    import numpy as np

    lens = np.asarray(payload["uih_len"])
    own = [k for k in payload if k.startswith("_offsets_")]
    shared = [k for k in payload if k.startswith("_arena_")
              and f"_offsets_{k[len('_arena_'):]}" not in payload]
    return (int(bool(shared) and lens.sum() > 0)
            + sum(int(np.diff(np.asarray(payload[k])).sum() > 0)
                  for k in own))


def timed_trainer(Trainer):
    """The port's Trainer with each step marked by CUDA events (start,
    gradients done, AdamW done) and its host end time, and a profiler
    advanced after each step."""
    import torch

    class TimedTrainer(Trainer):
        prof = None

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.marks = []     # per step: [start, grads done, AdamW done]
            self.ends = []      # per step: host clock at its end

        def _grads(self, batch):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = super()._grads(batch)
            e1.record()
            self.marks.append([e0, e1])
            return out

        def run_step(self, batch):
            out = super().run_step(batch)   # float() of the stats syncs
            e2 = torch.cuda.Event(enable_timing=True)
            e2.record()
            self.marks[-1].append(e2)
            self.ends.append(time.perf_counter())
            self.prof.step()
            return out

    return TimedTrainer


def main_path_phase():
    import numpy as np
    import torch

    from repro_torch.configs.dlrm_uih import FULL
    from repro_torch.data import open_feed
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.dpp.device_mat import densify_host
    from repro_torch.kernels.fused import ops
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    t0 = time.perf_counter()
    sim = build_sim()
    say("main", f"sim built in {time.perf_counter() - t0:.3f} s: "
                f"{len(sim.examples)} examples")
    t0 = time.perf_counter()
    params = R.init_dlrm_uih(FULL, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say("main", f"FULL DLRM-UIH params on the card in "
                f"{time.perf_counter() - t0:.3f} s: {n_params} float32 "
                f"(seq_len {FULL.seq_len}, d_seq {FULL.d_seq}, "
                f"{FULL.compute_dtype})")

    seen = {"microbatches": 0, "off_card": 0}

    def loss_fn(p, batch):
        seen["microbatches"] += 1
        seen["off_card"] += sum(v.device.type != DEVICE
                                for v in batch.values())
        return R.dlrm_uih_loss(p, R.dlrm_uih_prep(batch, FULL), FULL)

    trainer = timed_trainer(Trainer)(loss_fn, params, TrainerConfig(
        opt=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=STEPS),
        grad_accum=2, log_every=5))
    feed = open_feed(feed_spec(), sim, device=DEVICE)
    rec = recording_materializer(feed.prefetcher.materialize)
    feed.prefetcher.materialize = rec          # before the first get()
    torch.cuda.reset_peak_memory_stats()
    # device activity only: recording host ops would slow the dispatch the
    # traced steps are made of
    trace = profile(activities=[ProfilerActivity.CUDA], schedule=schedule(
        wait=STEPS - PROFILE_STEPS - 1, warmup=1, active=PROFILE_STEPS,
        repeat=1))
    ops.fused_densify.launches = 0             # count the main path only
    t0 = time.perf_counter()
    try:
        with trace:
            trainer.prof = trace
            trainer.fit(feed, max_steps=STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.fused_densify.launches
    finally:
        feed.close(timeout=30.0)
    peak = torch.cuda.max_memory_allocated()
    cs = feed.client_stats

    losses = [h["loss"] for h in trainer.history]
    require(trainer.step == STEPS, f"trained {trainer.step} of {STEPS} steps")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(seen["off_card"] == 0 and seen["microbatches"] == 2 * STEPS,
            f"batch tensors off the card: {seen}")
    expected = sum(launches_called_for(p) for p in rec.payloads)
    groups = launches / max(len(rec.payloads), 1)
    require(launches > 0 and launches == expected,
            f"fused_densify launches {launches} != the {expected} the "
            f"{len(rec.payloads)} transferred payloads call for")
    say("main", f"fused_densify launched {launches} times for "
                f"{len(rec.payloads)} transferred batches ({groups:g} groups "
                f"each), {cs.full_batches} delivered to the trainer")
    payload, dev = rec.payloads[0], rec.first
    host = densify_host(payload)
    require(list(dev) == list(host), "first batch keys differ from "
                                     "densify_host")
    for k, want in host.items():
        got = dev[k].cpu().numpy()
        require(got.dtype == want.dtype and got.shape == want.shape
                and got.tobytes() == want.tobytes(),
                f"first batch {k!r} differs from densify_host")
    lens = np.concatenate([np.asarray(p["uih_len"]) for p in rec.payloads])
    fill = float(np.asarray(payload["uih_len"]).clip(max=L_MAIN).mean()
                 / L_MAIN)
    fill_all = float(lens.clip(max=L_MAIN).mean() / L_MAIN)
    say("main", f"first batch == densify_host of its payload, byte for byte "
                f"({len(host)} keys, fill {fill:.3f}, uih_timestamp max "
                f"{int(host['uih_timestamp'].max())}); mean fill of all "
                f"transferred batches {fill_all:.3f}")
    dense_bytes = sum(v.nbytes for p in rec.payloads
                      for v in densify_host(p).values())
    require(0 < cs.h2d_bytes < dense_bytes,
            f"h2d_bytes {cs.h2d_bytes} not below dense {dense_bytes}")
    say("main", f"{STEPS} AdamW steps (grad_accum 2, batch {BATCH}) in "
                f"{wall:.3f} s = {STEPS / wall:.3f} steps/s; losses "
                f"{losses[0]:.5f} -> {losses[-1]:.5f}, all finite; peak "
                f"memory {peak} B; h2d {cs.h2d_bytes} B vs dense "
                f"{dense_bytes} B; starved {cs.starved_time_s:.6f} s "
                f"(host {cs.starved_host_s:.6f} s, h2d "
                f"{cs.starved_h2d_s:.6f} s), h2d time {cs.h2d_time_s:.6f} s")
    step_profile(trainer, trace)
    return launches


def step_profile(trainer, trace) -> None:
    """Print where the main path's steps went: steps/s over the untraced
    steps after two warm-up steps, the CUDA-event split of each such step,
    and, over the traced last steps, the device's busy share, the largest
    kernels and fused_densify's own device time on the fed batches."""
    import torch

    untraced = STEPS - PROFILE_STEPS
    ends = trainer.ends
    steady = range(2, untraced)        # steps 3.. of the untraced ones
    wall = ends[untraced - 1] - ends[1]
    split = [(m[0].elapsed_time(m[1]), m[1].elapsed_time(m[2]))
             for m in (trainer.marks[i] for i in steady)]
    grads_ms = sum(g for g, _ in split) / len(split)
    opt_ms = sum(o for _, o in split) / len(split)
    say("profile", f"steps 3-{untraced} (untraced): {len(steady)} steps in "
                   f"{wall:.6f} s = {len(steady) / wall:.3f} steps/s; per "
                   f"step gradients {grads_ms:.3f} ms (forward + backward of "
                   f"two microbatches), AdamW {opt_ms:.3f} ms (with the "
                   f"step's stats readback) (CUDA events)")
    kernels = [e for e in trace.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    require(bool(kernels), "the profiler saw no device time on the main path")
    traced_wall = ends[-1] - ends[untraced - 1]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    densify = [e for e in kernels if "fused_densify_kernel" in e.key]
    n = sum(e.count for e in densify)
    densify_ms = sum(e.self_device_time_total for e in densify) / 1e3
    in_path = (f"{densify_ms / n:.6f} ms over {n} launches" if n
               else "not launched in the window")
    say("profile", f"steps {untraced + 1}-{STEPS} (traced): wall "
                   f"{traced_wall:.6f} s, device kernels {busy_s:.6f} s = "
                   f"{100 * busy_s / traced_wall:.1f}% of the wall; "
                   f"fused_densify device time {in_path}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        per_step = e.self_device_time_total / 1e3 / PROFILE_STEPS
        say("profile", f"{per_step:10.3f} ms/step "
                       f"x{e.count / PROFILE_STEPS:<6g} {e.key[:100]}")


# ---------------------------------------------------------------------------
# phase 5: the model on the card agrees with the CPU on a small input
# ---------------------------------------------------------------------------

def model_check_phase():
    import numpy as np
    import torch

    from repro_torch.configs.dlrm_uih import SMOKE
    from repro_torch.models import recsys as R
    from repro_torch.tree import tree_map

    # float32 products in full precision on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    b, s = 8, SMOKE.seq_len
    lens = rng.integers(0, s + 1, b)
    batch = {
        "uih_item_id": rng.integers(0, SMOKE.item_vocab, (b, s)),
        "uih_action_type": rng.integers(0, 16, (b, s)),
        "uih_mask": np.arange(s)[None, :] >= (s - lens)[:, None],
        "cand_item_id": rng.integers(0, SMOKE.item_vocab, b),
        "sparse_ids": rng.integers(0, SMOKE.field_vocab, (b, SMOKE.n_sparse)),
        "dense": rng.random((b, SMOKE.n_dense)).astype(np.float32),
        "label": (rng.random(b) < 0.3).astype(np.float32),
    }
    cpu = R.init_dlrm_uih(SMOKE, seed=SEED, device="cpu")
    card = tree_map(lambda t: t.detach().to(DEVICE), cpu)
    want = R.dlrm_uih_forward(cpu, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, SMOKE)
    got = R.dlrm_uih_forward(card, {k: torch.from_numpy(v).to(DEVICE)
                                    for k, v in batch.items()}, SMOKE)
    err = float((got.detach().cpu() - want.detach()).abs().max())
    require(got.shape == (b,) and bool(torch.isfinite(got).all())
            and torch.allclose(got.detach().cpu(), want.detach(), rtol=1e-4,
                               atol=1e-5),
            f"SMOKE forward on the card differs from the CPU: {err}")
    say("model", f"SMOKE DLRM-UIH forward on the card == CPU float32 within "
                 f"rtol 1e-4, atol 1e-5 (max abs diff {err:.3e})")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need a CUDA card", file=sys.stderr)
        return 1
    smi = smi_line()
    say("device", f"{torch.cuda.get_device_name(0)} x "
                  f"{torch.cuda.device_count()}; {smi}; torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import build
    from repro_torch.kernels.fused import ops

    t0 = time.perf_counter()
    ops.LIBRARY.lib()
    ptxas = [ln.strip() for ln in ops.LIBRARY.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", f"{ops.LIBRARY.path.name} built in "
                 f"{time.perf_counter() - t0:.3f} s into {build.BUILD_DIR}; "
                 f"ptxas: {' | '.join(ptxas) or 'cached build'}")

    entry = densify_phase()
    model_check_phase()
    entry["launches"] = main_path_phase()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: entry[k] for k in keys}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
