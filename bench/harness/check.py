"""What the harness reads off the program for its metrics and its check,
and the check itself: the program's batches and first steps held against
the plain reference.

The numbers compared (each with its limit in the cell's file):

* ``batch_mismatch``: elements of the compared device batches that differ
  from the reference's rebuild from the generated events and requests,
  plus rows repeated within the first steps (exact: limit 0);
* ``loss_gap``, ``grad_gap``, ``change_gap``: ``reference.compare``.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List

import numpy as np
import torch

from bench.harness import sim as S
from bench.harness import trace as T
from bench.reference import weights as W
from bench.reference import densify_bytes
from bench.reference import history as H
from bench.reference.compare import gaps
from bench.reference.events import EventStream, day_requests, MS_PER_DAY
from bench.reference.precision import STATED, Precision
from bench.reference.train import change_norms, follow, leaf_norms


# -- the program's readings ---------------------------------------------------

def program_grad_norms(m_tree, beta1: float) -> List[float]:
    """Each leaf's first gradient as AdamW took it: ``m / (1 - beta1)``
    after one step."""
    return leaf_norms(W.leaves(m_tree), 1.0 / (1.0 - beta1))


def host_copy(flat, layout) -> List:
    """The starting weights' leaves, copied to the host before the first
    step, so that the check never holds a second model on the card."""
    return W.leaves(W.split(flat.to("cpu", copy=True), layout))


def program_change_norms(params, start) -> List[float]:
    """Each leaf's change from ``start`` (``host_copy``'s leaves)."""
    return change_norms(W.leaves(params), start)


def feed_counters(feed) -> Dict[str, float]:
    cs = dataclasses.replace(feed.client_stats)
    ws = feed.pool.merged_worker_stats()
    return {"starved_s": cs.starved_time_s, "batches": cs.full_batches,
            "h2d_bytes": cs.h2d_bytes, "h2d_s": cs.h2d_time_s,
            "dpp_busy_s": ws.busy_time_s, "dpp_examples": ws.examples}


def counter_growth(a: Dict[str, float], b: Dict[str, float]
                   ) -> Dict[str, float]:
    return {k: b[k] - a[k] for k in a}


def break_feed(feed, alter) -> None:
    """Tests only: every batch the feed delivers passes ``alter``."""
    get = feed.get

    def broken(*args, **kwargs):
        out = get(*args, **kwargs)
        return out if out is None else alter(out)

    feed.get = broken


def read_trace(prof, window_s: float, phases) -> Dict:
    iv = T.device_intervals(prof)
    if not iv:
        raise RuntimeError("the profiler saw no device activity in the "
                           "window")
    lo, hi = iv[0][0], max(b for _, b, _ in iv)
    busy = T.busy_ns(iv, lo, hi) / 1e9
    aligned = bool(phases) and lo - 10**9 <= phases[0][0] <= hi + 10**9
    return {"busy_s": busy, "window_s": window_s,
            "device_ops": T.top_ops(iv),
            "idle_gaps": T.idle_gaps(iv, lo, hi, phases if aligned else [])}


def densify_reading(prof, calls, t0: float, t1: float):
    """The least time of the window's ``fused_densify`` launches over their
    device time: mean least bytes a launch (recorded) at 3.35 TB/s over
    mean kernel time a launch (traced). None when none ran."""
    kernels = [b - a for a, b, name in T.device_intervals(prof)
               if "fused_densify_kernel" in name]
    mine = [(n, k) for t, n, k in calls if t0 <= t <= t1 and k]
    launches = sum(k for _, k in mine)
    if not kernels or not launches:
        return None
    least_s = sum(n for n, _ in mine) / launches / densify_bytes.HBM_BYTES_PER_S
    return {"least_s": least_s, "device_s": statistics.mean(kernels) / 1e9,
            "launches": len(kernels)}


# -- the reference's side -----------------------------------------------------

def schedule(traffic: dict, seed: int):
    s = traffic["sim"]
    rng = S.request_rng(seed)
    reqs = []
    for day in range(s["days"]):
        reqs += day_requests(rng, day, s["n_users"], s["n_items"],
                             s["requests_per_user_day"])
    return H.requests_by_key(reqs)


def rebuild(traffic: dict, seed: int, first, compared):
    """(``batch_mismatch``, the reference's dense batches of the first
    steps) for the program's ``first`` step batches and all its
    ``compared`` batches (host dicts)."""
    stream = EventStream(S.stream_params(traffic, seed))
    reqs = schedule(traffic, seed)
    look = traffic["sim"]["lookback_days"] * MS_PER_DAY
    traits = traffic["uih_traits"]
    bad = 0
    for b in compared:
        keys = list(zip(b["user_id"].tolist(), b["request_ts"].tolist(),
                        b["cand_item_id"].tolist()))
        want, stamps = H.dense_batch(stream, reqs, keys, look,
                                     traffic["seq_len"], traits,
                                     traffic["candidate_fields"],
                                     traffic["label_fields"])
        mask = want["uih_mask"]
        bad += H.mismatches(H.canonical(b, stamps, mask, traits),
                            H.canonical(want, stamps, mask, traits))
    ref_first = []
    seen = set()
    for b in first:
        keys = list(zip(b["user_id"].tolist(), b["request_ts"].tolist(),
                        b["cand_item_id"].tolist()))
        bad += len(keys) - len(set(keys)) + len(set(keys) & seen)
        seen |= set(keys)
        ref_first.append(H.dense_batch(stream, reqs, keys, look,
                                       traffic["seq_len"], traits,
                                       traffic["candidate_fields"],
                                       traffic["label_fields"])[0])
    return bad, ref_first


def on_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def reference_readings(ref, cfg, traffic, seed, device, ref_first, opt,
                       P: Precision = STATED, half: bool = False):
    inputs = [ref.prep(on_device(b, device), cfg) for b in ref_first]
    return follow(ref, cfg, seed, device, inputs, traffic["grad_accum"], opt,
                  P, half=half)


def check(ref, cfg, traffic, seed, device, first, compared, prog, opt
          ) -> Dict[str, float]:
    bad, ref_first = rebuild(traffic, seed, first, compared)
    want = reference_readings(ref, cfg, traffic, seed, device, ref_first, opt)
    return {"batch_mismatch": bad, **gaps(prog, want)}
