"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the readings the metric files turn into numbers.

Set-up builds the port's data platform from the seed, draws the weights on
the card, builds ONE trainer and drives it through its first ``WARM_STEPS``
steps by the window's own call: ``Trainer.fit`` over ``open_feed`` (a feed
mix), or ``Trainer.run_step`` over a ring of device batches the feed made
in set-up (a ring mix). Those steps warm every shape; the window then goes
on with the same trainer for ``--seconds``. The reference follows the first
steps once the window has closed and the program's state is freed.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from bench.harness import check as C
from bench.harness import sim as S
from bench.reference import weights as W
from bench.harness.manifest import Cell, family
from bench.reference import densify_bytes
from bench.reference import flops as F
from bench.reference.adamw import AdamW

WARM_STEPS = 3             # set-up steps; the reference follows these
FEED_CLOSE_S = 60.0        # bound on draining the feed after the window


def say(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Readings:
    """What one run measured; the metric files read these."""
    cell: str
    batch: int
    window_s: float = 0.0
    window_start: float = 0.0
    step_ends: List[float] = dataclasses.field(default_factory=list)
    examples: int = 0
    setup_s: float = 0.0
    peak_bytes: int = 0
    flops_per_example: float = 0.0
    feed: Optional[dict] = None          # counter growth over the window
    grad_ms: List[float] = dataclasses.field(default_factory=list)
    adamw_ms: List[float] = dataclasses.field(default_factory=list)
    densify: Optional[dict] = None       # bound and device seconds, launches
    trace: Optional[dict] = None         # busy_s, window_s, breakdown


def optimizer(traffic: dict) -> AdamW:
    o = traffic["optimizer"]
    return AdamW(lr=o["lr"], warmup_steps=o["warmup_steps"],
                 total_steps=o["total_steps"])


def dataset_spec(traffic: dict, seed: int, rows: int):
    """The port's ``DatasetSpec`` of a mix: its projection, features and
    feed knobs, reshuffled by the seed."""
    from repro_torch.core.projection import TenantProjection
    from repro_torch.data import DatasetSpec, SimSource
    from repro_torch.dpp.featurize import FeatureSpec

    groups = {g: tuple(t) for g, t in traffic["projection"].items()}
    L = traffic["seq_len"]
    return DatasetSpec(
        tenant=TenantProjection(traffic["tenant"], seq_len=L,
                                feature_groups=tuple(groups),
                                traits_per_group=groups),
        source=SimSource(min_rows=rows),
        batch_size=traffic["batch"], base_batch_size=traffic["base_batch"],
        prefetch_depth=traffic["prefetch_depth"],
        n_workers=traffic["n_workers"], device_materialize=True,
        reshuffle_seed=seed,
        features=FeatureSpec(seq_len=L, uih_traits=traffic["uih_traits"],
                             candidate_fields=traffic["candidate_fields"],
                             label_fields=traffic["label_fields"]))


def host_batch(batch) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in batch.items()}


class Recorder:
    """The densify roofline's inputs, recorded in the transfer thread
    (traced runs only): the least bytes of each ``fused_densify`` launch a
    payload calls for, and when."""

    def __init__(self):
        self.calls = []        # (host time, least bytes, launches)

    def wrap(self, base):
        rec = self

        class Recording(type(base)):
            def __call__(self, payload):
                rec.calls.append((time.perf_counter(),
                                  *densify_bytes.of_payload(payload,
                                                            self.ts_trait)))
                return super().__call__(payload)

        return Recording(ts_trait=base.ts_trait, device=base.device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, faults: Optional[dict] = None, judge=None) -> dict:
    """One run; returns ``{"readings", "checks", "attempted", "failed"}``.
    ``faults`` (tests only) breaks the program under the harness; ``judge``
    (calibration only) replaces ``check.check``."""
    import torch

    from repro_torch.data import open_feed
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    faults = faults or {}
    cfg, traffic = cell.config, cell.traffic
    fam = family(cfg)
    ref = fam.reference
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    split = {"import": time.perf_counter() - t_start}
    r = Readings(cell=cell.name, batch=traffic["batch"])
    ring_mode = traffic["mode"] == "ring"

    def phase(name: str, t0: float) -> float:
        t1 = time.perf_counter()
        split[name] = split.get(name, 0.0) + (t1 - t0)
        return t1

    t = time.perf_counter()
    sim = S.build_sim(traffic, seed)
    t = phase("sim", t)
    layout = ref.layout(cfg)
    flat, tree = W.draw(layout, seed, dev)
    params = W.as_parameters(tree)
    if on_card:
        torch.cuda.synchronize()
    t = phase("params", t)
    start = C.host_copy(flat, layout)          # the check's, not set-up
    del flat
    t_copy = time.perf_counter() - t
    t += t_copy
    opt = optimizer(traffic)
    loss_fn = fam.program_loss(cfg)
    if "loss" in faults:
        loss_fn = faults["loss"](loss_fn)
    tcfg = TrainerConfig(opt=AdamWConfig(lr=opt.lr,
                                         warmup_steps=opt.warmup_steps,
                                         total_steps=opt.total_steps),
                         grad_accum=traffic["grad_accum"], log_every=10**9,
                         max_wall_s=1e9)
    if on_card:
        torch.cuda.synchronize()
    t = phase("params", t)
    if on_card:
        from repro_torch.kernels.fused.ops import LIBRARY
        LIBRARY.lib()
    t = phase("kernels", t)

    state = {"t_bookkeeping": 0.0, "window_start": None, "deadline": None,
             "first": [], "sampled": [], "marks": [], "phases": [],
             "prog": {}}
    rng = np.random.default_rng((seed, 2))
    lo = WARM_STEPS + 1
    sample_steps = set((lo + rng.choice(traffic["check_window_span"],
                                        traffic["check_window_batches"],
                                        replace=False)).tolist())
    rec = Recorder() if trace else None
    prof = None
    counters = {}

    class BenchTrainer(Trainer):
        def _grads(self, batch):
            timed = trace and on_card and self.step >= WARM_STEPS
            if timed:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            t_dispatch = time.time_ns()
            out = super()._grads(batch)
            state["host"] = (t_dispatch, time.time_ns())
            if timed:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                state["marks"].append([e0, e1])
            return out

        def run_step(self, batch):
            k = self.step + 1
            t_wait = state.get("t_prev_end_ns")
            if faults.get("frozen"):
                with torch.no_grad():
                    loss = float(self.loss_fn(self.params, batch))
                out = {"loss": loss, "grad_norm": 0.0, "lr": 0.0}
                self.step += 1
                self.history.append(out)
            else:
                out = super().run_step(batch)
            t_end = time.perf_counter()
            t_end_ns = time.time_ns()
            if trace and on_card and k > WARM_STEPS:
                e2 = torch.cuda.Event(enable_timing=True)
                e2.record()
                state["marks"][-1].append(e2)
            if k > WARM_STEPS:
                r.step_ends.append(t_end)
                if trace and "host" in state:
                    t_d, t_g = state["host"]
                    state["phases"] += [
                        (t_wait, t_d, "waiting for a batch"),
                        (t_d, t_g, "forward and backward"),
                        (t_g, t_end_ns, "optimizer and loss readback")]
                if k in sample_steps:
                    state["sampled"].append(batch)
            else:
                t0 = time.perf_counter()
                state["first"].append(batch)
                if k == 1:
                    split["first_step"] = t0 - state["t_warm0"]
                    state["prog"]["grad_norm"] = C.program_grad_norms(
                        self.opt_state.m, opt.beta1)
                if k == WARM_STEPS:
                    state["prog"]["change_norm"] = C.program_change_norms(
                        self.params, start)
                    state["t_bookkeeping"] += time.perf_counter() - t0
                    start_window(self)
                else:
                    state["t_bookkeeping"] += time.perf_counter() - t0
            state["t_prev_end_ns"] = time.time_ns()
            return out

    def start_window(trainer):
        nonlocal prof
        if trace and on_card:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        if on_card:
            torch.cuda.synchronize()
        now = time.perf_counter()
        split["warm_steps"] = (now - state["t_warm0"] - split["first_step"]
                               - state["t_bookkeeping"])
        r.setup_s = now - t_start - t_copy - state["t_bookkeeping"]
        state["window_start"] = r.window_start = now
        state["deadline"] = now + seconds
        trainer.cfg.max_wall_s = state["deadline"] - state["t_warm0"]
        if feed is not None:
            counters["start"] = C.feed_counters(feed)
        state["trace_t0"] = now
        state["t_prev_end_ns"] = time.time_ns()

    trainer = BenchTrainer(loss_fn, params, tcfg)
    feed = None
    try:
        if ring_mode:
            spec = dataset_spec(traffic, seed, traffic["ring_batches"]
                                * traffic["batch"])
            feed = open_feed(spec, sim, device=device)
            ring = []
            while len(ring) < traffic["ring_batches"]:
                b = feed.get(timeout=600.0)
                if b is None:
                    raise RuntimeError("the feed ended before the ring filled")
                ring.append(b)
            feed.close(timeout=FEED_CLOSE_S)
            feed = None
            if "batch" in faults:
                ring = [faults["batch"](b) for b in ring]
            t = phase("feed", t)
            state["t_warm0"] = time.perf_counter()
            i = 0
            while True:
                trainer.run_step(ring[i % len(ring)])
                i += 1
                if (state["deadline"] is not None
                        and time.perf_counter() >= state["deadline"]):
                    break
            ring_host = [host_batch(b) for b in ring]
        else:
            rows = math.ceil(traffic["max_rows_per_s"] * seconds) + (
                WARM_STEPS + traffic["prefetch_depth"] + 2) * traffic["batch"]
            spec = dataset_spec(traffic, seed, rows)
            feed = open_feed(spec, sim, device=device)
            if rec is not None:
                feed.prefetcher.materialize = rec.wrap(
                    feed.prefetcher.materialize)
            if "batch" in faults:
                C.break_feed(feed, faults["batch"])
            t = phase("feed", t)
            state["t_warm0"] = time.perf_counter()
            trainer.fit(feed)
            if feed.ended:
                raise RuntimeError(
                    f"the feed ran out of rows before the window closed: "
                    f"{rows} rows planned (traffic max_rows_per_s too low)")
        if on_card:
            torch.cuda.synchronize()
        t_close = time.perf_counter()
        if prof is not None:
            state["trace_t1"] = t_close
            prof.stop()
        r.window_s = max(state["deadline"], t_close) - state["window_start"]
        r.examples = len(r.step_ends) * traffic["batch"]
        r.peak_bytes = (torch.cuda.max_memory_allocated() if on_card else 0)
        if feed is not None:
            counters["end"] = C.feed_counters(feed)
            r.feed = C.counter_growth(counters["start"], counters["end"])
            feed.close(timeout=FEED_CLOSE_S)
            feed = None
    finally:
        if feed is not None:
            feed.close(timeout=FEED_CLOSE_S)
    say("set-up split (s): " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in split.items())
        + f"; check bookkeeping {t_copy + state['t_bookkeeping']:.3f} "
        "(not set-up)")

    for m in state["marks"]:
        if len(m) == 3:
            r.grad_ms.append(m[0].elapsed_time(m[1]))
            r.adamw_ms.append(m[1].elapsed_time(m[2]))
    if prof is not None:
        r.trace = C.read_trace(prof, state["trace_t1"] - state["trace_t0"],
                               state["phases"])
        r.densify = C.densify_reading(prof, rec.calls, state["trace_t0"],
                                      state["trace_t1"])
    history = list(trainer.history)
    first = [host_batch(b) for b in state["first"]]
    sampled = [host_batch(b) for b in state["sampled"]]
    del trainer, params, tree, start, state["first"], state["sampled"]
    del loss_fn
    if ring_mode:
        del ring
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    if trace:
        r.flops_per_example = F.per_example(
            ref, cfg, traffic["batch"] // traffic["grad_accum"],
            traffic["seq_len"])
    compared = ring_host if ring_mode else first + sampled
    prog = dict(state["prog"], loss=[h["loss"] for h in history[:WARM_STEPS]])
    checks = (judge or C.check)(ref, cfg, traffic, seed, dev, first, compared,
                                prog, opt)
    window = history[WARM_STEPS:]
    return {"readings": r, "checks": checks,
            "attempted": len(window),
            "failed": sum(not math.isfinite(h["loss"]) for h in window)}
