"""Device-side late materialization (DESIGN §3) on the PyTorch port: compact
jagged payloads vs host-dense batches.

Port of ``benchmarks/bench_device_mat.py``: the same result, ``derived``
keys and claims.

1. **byte identity** — the jagged-emission client + ``DeviceMaterializer``
   (the CUDA ``fused_densify`` kernel on a card, counted in its
   ``launches``) produce exactly the batches the host-dense path produces
   after a copy to the device (same keys, dtypes, values; the port keeps
   int64 lanes int64, where the reference's device put wraps them);
2. **the host featurize stage shrinks toward pure I/O** — the client's
   host-side cost per batch is strictly below the host-densify baseline,
   and the H2D payload is strictly smaller.

Both host-stage times are the median of ``ROUNDS`` rounds over the same
features (the reference takes 3, the host-dense path first in each), so
the gap does not rest on one noisy round, and the two paths take turns at
running first in a round: whichever runs right after the host-dense path
pays for the slot memory that path just freed. The host-time claim is
asserted at the full config (L=2048, 64-row batches); ``quick`` runs the
reference's quick shapes (L=1024, 16-row batches) and reports the gap
without asserting it, since there the two host stages are within noise
of each other once the process's heap is warm. Byte identity and the
byte counts are asserted at both. The transfer-stage times are reported,
not asserted: each is the median over the full batches of one pass (the
reference reports the pass's mean), because a few batches of a pass can
stall for 10-25 ms (the device allocator growing again after
``empty_cache``, another process leaving the card) or for seconds (the
process's first use of the card), and a mean over 12 batches then reads
as a copy ten times slower than a typical batch's. On a card each batch's copy or densify is waited for; on the CPU
the "device" path is the kernel's plain version and not a device time. ``materialization_roofline`` carries the link/HBM model.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from benchmarks_torch.common import BenchResult, synchronize
from repro_torch.core.versioning import TrainingExample
from repro_torch.dpp.client import RebatchingClient
from repro_torch.dpp.device_mat import (DeviceMaterializer,
                                        jagged_batch_nbytes, to_device)
from repro_torch.dpp.featurize import FeatureSpec, featurize_jagged
from repro_torch.roofline.analysis import materialization_roofline

TS0 = 3_000_000_000  # > 2^31: exercises the windowed delta-decode path
ROUNDS = 7


def _synth_features(n_batches: int, rows: int, seq_len: int, mean_len: int,
                    seed: int = 7):
    rng = np.random.default_rng(seed)
    spec = FeatureSpec(seq_len=seq_len,
                       uih_traits=("item_id", "action", "timestamp"),
                       candidate_fields=("item_id",), label_fields=("click",))
    feats = []
    for k in range(n_batches):
        exs, uihs = [], []
        for i in range(rows):
            ln = int(rng.integers(1, 2 * mean_len))
            uihs.append({
                "item_id": rng.integers(0, 50_000, ln).astype(np.int64),
                "action": rng.integers(0, 8, ln).astype(np.int32),
                "timestamp": TS0 + np.sort(
                    rng.integers(0, 10**6, ln)).astype(np.int64),
            })
            exs.append(TrainingExample(
                request_id=f"r{k}-{i}", user_id=i, request_ts=TS0 + i,
                label_ts=TS0 + i + 1,
                candidate={"item_id": np.int64(rng.integers(0, 50_000))},
                labels={"click": np.float32(rng.integers(0, 2))}))
        feats.append(featurize_jagged(exs, uihs, spec))
    return feats


def _client_path(feats, full_batch: int, emit_jagged: bool):
    """Push every base batch through a rebatching client; return the emitted
    full batches and the host-stage wall time (the featurize-tail cost the
    device path is meant to shrink). The client's queue holds every full
    batch: nothing drains it while the batches go in (the reference's
    default of 8 blocks the full config's 12 forever)."""
    c = RebatchingClient(full_batch_size=full_batch, shuffle_seed=0,
                         emit_jagged=emit_jagged, buffer_batches=len(feats))
    t0 = time.perf_counter()
    for jf in feats:
        c.put_jagged(jf)
    c.close()
    out = []
    while True:
        b = c.get_full_batch()
        if b is None:
            break
        out.append(b)
    return out, time.perf_counter() - t0


def _transfer_stage(dense, jag, dev) -> tuple:
    """Each full batch onto ``dev`` both ways, the host-dense batch by a
    copy of each array and the compact one by ``DeviceMaterializer``, each
    waited for and held byte for byte against the other: the seconds of
    each batch's dense copy and of its device path, in batch order."""
    mat = DeviceMaterializer(device=dev)
    xfer_dense, xfer_jag = [], []
    for d, jg in zip(dense, jag):
        t0 = time.perf_counter()
        want = {k: to_device(np.asarray(v), dev) for k, v in d.items()}
        synchronize(dev)
        xfer_dense.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        got = mat(jg)
        synchronize(dev)
        xfer_jag.append(time.perf_counter() - t0)
        # byte identity: the device path IS the host path, just materialized
        # on the other side of the link
        assert set(got) == set(d), (sorted(got), sorted(d))
        for k in d:
            assert got[k].dtype == want[k].dtype, (k, got[k].dtype)
            assert got[k].device == want[k].device, (k, got[k].device)
            assert torch.equal(got[k], want[k]), k
    return xfer_dense, xfer_jag


def run(quick: bool = False, device: str = "cuda") -> List[BenchResult]:
    dev = torch.device(device)
    if quick:
        n_batches, rows, seq_len, mean_len, full_b = 12, 8, 1024, 32, 16
    else:
        n_batches, rows, seq_len, mean_len, full_b = 48, 16, 2048, 96, 64
    feats = _synth_features(n_batches, rows, seq_len, mean_len)

    # median of ROUNDS: the host-stage gap is the headline, keep it
    # noise-robust. The paths take turns at running first in a round: the
    # one that runs right after the host-dense path pays for the memory
    # that path just freed
    host_dense_s, host_jag_s = [], []
    for i in range(ROUNDS):
        for emit_jagged in ((False, True) if i % 2 == 0 else (True, False)):
            out, t = _client_path(feats, full_b, emit_jagged=emit_jagged)
            if emit_jagged:
                jag = out
                host_jag_s.append(t)
            else:
                dense = out
                host_dense_s.append(t)
    host_dense_s.sort()
    host_jag_s.sort()
    t_dense = host_dense_s[ROUNDS // 2]
    t_jag = host_jag_s[ROUNDS // 2]
    assert len(dense) == len(jag) and dense

    xfer_dense, xfer_jag = _transfer_stage(dense, jag, dev)
    n = len(dense)
    dense_bytes = sum(v.nbytes for d in dense for v in d.values())
    jag_bytes = sum(jagged_batch_nbytes(jg) for jg in jag)
    arena_rows = sum(int(np.sum(np.minimum(jg["uih_len"], seq_len)))
                     for jg in jag)

    # the two claims: strictly fewer H2D bytes per batch than the
    # host-densify baseline AND, at the full config's long sequences,
    # strictly less host featurize-stage time (reported only when quick)
    assert jag_bytes < dense_bytes, (jag_bytes, dense_bytes)
    assert quick or t_jag < t_dense, (t_jag, t_dense)

    roof = materialization_roofline(
        batch=full_b, seq_len=seq_len, n_traits=3,
        arena_rows=arena_rows // n, itemsize=4)
    return [BenchResult(
        "device_mat/late_materialization",
        1e6 * t_jag / n,
        {"host_dense_us_per_batch": round(1e6 * t_dense / n, 1),
         "host_jagged_us_per_batch": round(1e6 * t_jag / n, 1),
         "host_stage_speedup": round(t_dense / t_jag, 2),
         "h2d_dense_bytes_per_batch": dense_bytes // n,
         "h2d_compact_bytes_per_batch": jag_bytes // n,
         "h2d_savings_pct": round(100.0 * (1 - jag_bytes / dense_bytes), 1),
         "fill_pct": round(100.0 * roof.fill, 1),
         "xfer_dense_us_per_batch": round(1e6 * float(np.median(xfer_dense)),
                                          1),
         "xfer_jagged_interp_us_per_batch": round(
             1e6 * float(np.median(xfer_jag)), 1),
         "roofline_t_host_us": round(1e6 * roof.t_host_path, 2),
         "roofline_t_device_us": round(1e6 * roof.t_device_path, 2),
         "roofline_device_wins": roof.device_wins},
    )]


if __name__ == "__main__":
    for r in run():
        print(r.csv())
