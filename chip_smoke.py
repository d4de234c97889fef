#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. It builds every CUDA kernel from ``src/repro_torch``
into ``build/`` (one nvcc a source, all at once), holds each kernel against
its plain PyTorch version on the card, and drives four paths of the port
over one ``ProductionSim``:

0. The standalone kernels: the sim's last 32 training examples, materialized
   and featurized as the feed's host plane does (L=2048), through
   ``jagged_to_padded`` (each trait arena, and (N, 128) float32 and bf16 row
   blocks) and ``delta_decode`` (the timestamp lane as int64 row deltas and
   as int32 window-relative deltas), each checked against ``to_padded()``;
   then one device kernel a ``delta_decode`` call with mixed int32/int64
   inputs, its timings, and the split of a call's host time.
1. Train: the full-width DLRM-UIH (``configs/dlrm_uih.FULL``) for a few AdamW
   steps from device-materialized batches:

     ProductionSim -> open_feed(device_materialize=True, prefetch_depth=2)
     -> compact jagged payloads -> DeviceMaterializer (CUDA fused_densify)
     -> Trainer.fit

   The last ``PROFILE_STEPS`` steps are traced with ``torch.profiler``
   (device activity only) and every step is split by CUDA events into
   gradients and AdamW, so the step's breakdown comes from the path's own
   batches. Its tensors are then released.
2. Serve: the full-width two-tower retriever
   (``configs/two_tower_retrieval.FULL``, 30.7 GB of float32 parameters, a
   5.1 GB bf16 index over 10,000,384 items) behind ``RetrievalServer``, with
   the user-embedding cache off and on, answering the same request mix:

     RequestCoalescer -> GenerationLease -> Materializer -> featurize
     -> two_tower_user (or a cache hit) -> CandidateIndex.top_k

   Before it, ``embedding_bag`` on the server's item table: every edge
   case against its plain version, one device kernel a call (int64 ids, a
   bool mask, sum and mean), timings at L=100 and L=2048, and the split of
   a call's host time.
3. Late-materialize: the served users' histories through
   ``featurize_jagged`` and ``late_materialize`` on the server's item table
   (CUDA fused_densify, then CUDA embedding_bag with the mean combiner).

Each phase prints one line and raises on failure; nothing falls back to the
CPU. The line before the last is the card's name and power limit, the line
before that a JSON object with one entry per kernel (launches on the main
path, error against the plain version, times and bound), and the last line
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""
from __future__ import annotations

import gc
import itertools
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
BATCH = 32                 # rows per trainer batch (two microbatches of 16);
#                            also the users of the late_materialize batch
STEPS = 20
PROFILE_STEPS = 5          # the main path's last steps, traced by the profiler
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 bandwidth, NVIDIA data sheet
SERVE_REQUESTS = 256       # requests per wave, over the sim's users
SERVE_BATCH = 16           # the server's max_batch (its fixed padded shape)
TOP_K = 10
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


def turns_ms(kernel, library, iters: int = 200, rounds: int = 3):
    """``cuda_ms`` of a kernel's call and of its library yardstick, taken in
    turns (kernel, library, library, kernel), ``rounds`` times, so that a
    slow stretch of the shared host weighs on both alike; returns the median
    of each one's windows."""
    import statistics

    times = {kernel: [], library: []}
    for _ in range(rounds):
        for fn in (kernel, library, library, kernel):
            times[fn].append(cuda_ms(fn, iters))
    return statistics.median(times[kernel]), statistics.median(times[library])


def traced_kernels(fn, iters: int, name: str = "", attempts: int = 4
                   ) -> dict:
    """``{kernel name: (records, device us)}`` of the device kernels that
    ``iters`` calls of ``fn`` launch, from a ``torch.profiler`` trace (one
    warm-up cycle with tracing already on, so the counted cycle starts with
    the device tracer running). The trace drops records now and then, and
    once in a while all of them: a trace in which no kernel whose name
    contains ``name`` has records for half the calls is taken again, up to
    ``attempts`` traces in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            for n_calls in (10, iters):
                for _ in range(n_calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        found = {e.key: (e.count, e.self_device_time_total)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.count}
        if any(name in k and 2 * n >= iters for k, (n, _) in found.items()):
            break
        say("trace", f"trace {attempt + 1} of {attempts} kept "
                     f"{sum(n for n, _ in found.values())} records over "
                     f"{iters} calls, under half"
                     + ("; tracing again" if attempt + 1 < attempts else ""))
    return found


def device_ms(fn, iters: int = 200, name: str = "") -> float:
    """Device time per call of the kernels ``fn`` launches whose name
    contains ``name`` (all of them for ""), read from ``traced_kernels``:
    kernel durations only, no host dispatch.

    The trace may drop some kernel records, so a call's time is not the
    trace's total over ``iters``: it is, for each distinct kernel, its mean
    traced duration times the launches it makes a call (its traced count
    over ``iters``, rounded; one for the kernel ``name`` names)."""
    found = {k: v for k, v in traced_kernels(fn, iters, name).items()
             if name in k}
    require(bool(found), f"the profiler saw no device kernel {name!r}")
    n = sum(c for c, _ in found.values())
    require(not name or n <= iters,
            f"{n} {name} kernels traced for {iters} calls")
    per_call = [(us / c, round(c / iters) or int(bool(name)))
                for c, us in found.values()]
    require(any(k for _, k in per_call),
            f"under half of the {iters} calls' kernels were traced")
    ms = sum(us * k for us, k in per_call) / 1e3
    say("trace", f"{name or 'every kernel'}: {n} records over {iters} "
                 f"calls, {sum(k for _, k in per_call)} launches a call, "
                 f"{ms:.6f} ms a call")
    return ms


def kernels_a_call(fn, name: str, what: str, iters: int = 50) -> None:
    """Require that each call of ``fn`` launches exactly one device kernel,
    ``name``: every kernel a trace of ``iters`` calls records
    (``traced_kernels``) bears that name, and their count over ``iters``
    rounds to 1 (the trace may drop a record, never add one). Prints the
    count."""
    found = traced_kernels(fn, iters, name)
    n = sum(c for c, _ in found.values())
    per_call = round(n / iters)
    require(all(name in k for k in found) and n <= iters and per_call == 1,
            f"{what}: want one {name} a call, traced "
            f"{ {k: c for k, (c, _) in found.items()} } over {iters} calls")
    say("kernel", f"{what}: {per_call} device kernel a call ({n} records of "
                  f"{name} over {iters} calls, no other kernel)")


def host_us(fn, calls: int = 2000, chunk: int = 100) -> float:
    """Host microseconds a call of ``fn`` takes to return (its enqueue), on
    ``time.perf_counter_ns``: ``calls`` calls in loops of ``chunk`` with no
    synchronise inside a loop; the device is drained between loops, outside
    the clock, so a full launch queue never blocks the host."""
    import torch

    for _ in range(10):
        fn()
    total = 0
    for _ in range(calls // chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(chunk):
            fn()
        total += time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return total / 1e3 / (calls // chunk * chunk)


def host_split(what: str, wrapper, c_fn, c_args, library, lib_name: str,
               alloc, like) -> None:
    """Where a wrapper call's host time goes: (i) the wrapper's whole
    enqueue, (ii) the cached C function alone on arguments prepared
    beforehand (the ctypes call and the launch), (iii) the library
    yardstick's enqueue; and, inside (i) - (ii), the output's allocation
    ``alloc`` and the stream handle by the two candidates, for the card of
    the tensor ``like``."""
    import torch

    dev, idx = like.device, like.get_device()
    t = {"wrapper_us": host_us(wrapper),
         "c_us": host_us(lambda: c_fn(*c_args)),
         "library_us": host_us(library), "alloc_us": host_us(alloc),
         "stream_current_us": host_us(
             lambda: torch.cuda.current_stream(dev).cuda_stream),
         "stream_raw_us": host_us(
             lambda: torch._C._cuda_getCurrentRawStream(idx))}
    say("host", f"{what}: (i) wrapper {t['wrapper_us']:.3f} us a call; (ii) "
                f"cached C function alone {t['c_us']:.3f} us; (i) - (ii), the "
                f"wrapper's Python, {t['wrapper_us'] - t['c_us']:.3f} us, of "
                f"which the output's new_empty {t['alloc_us']:.3f} us and the "
                f"stream handle {t['stream_raw_us']:.3f} us "
                f"(torch._C._cuda_getCurrentRawStream; torch.cuda."
                f"current_stream(device).cuda_stream {t['stream_current_us']:.3f}"
                f" us); (iii) {lib_name} {t['library_us']:.3f} us "
                f"(perf_counter_ns, 2000 calls, no synchronise in a loop)")


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
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "library_device_ms": None}


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


def featurized_batch(sim):
    """The sim's last ``BATCH`` training examples, materialized as the
    feed's host plane does (the spec's ``WorkerPlan`` in a ``DPPWorker``)
    and featurized at ``L_MAIN`` with ``TRAITS``: a ``JaggedFeatures``."""
    from repro_torch.data.compile import compile_worker_plan
    from repro_torch.dpp.worker import DPPWorker

    worker = DPPWorker.from_plan(compile_worker_plan(feed_spec(), sim))
    return worker.process_jagged(sim.examples[-BATCH:])


# ---------------------------------------------------------------------------
# phase 4a: jagged_to_padded over the featurized FULL DLRM-UIH batch
# ---------------------------------------------------------------------------

D_SEQ = 128                # FULL DLRM-UIH's d_seq: the width of a row block
EPOCH_MS = 1_700_000_000_000   # an epoch-millisecond clock's 2023 start


def same_bytes(got, want, what: str) -> None:
    """Require equal dtype, shape and bytes (NaN payloads and -0.0
    included)."""
    import torch

    g, w = (torch.as_tensor(t).cpu().contiguous() for t in (got, want))
    require(g.dtype == w.dtype and g.shape == w.shape,
            f"{what}: {tuple(g.shape)}/{g.dtype} vs "
            f"{tuple(w.shape)}/{w.dtype}")
    require(torch.equal(g.view(torch.uint8), w.view(torch.uint8)),
            f"{what}: bytes differ")


def jagged_edge_cases(rng, dev):
    """name -> (values, offsets, max_len) on the card: the widths the kernel
    moves in 4- or 1-byte words, an arena that starts mid-line, every dtype
    width, and malformed, empty and degenerate offsets."""
    import numpy as np
    import torch

    def case(lens, d, dtype, first=0, max_len=64, offsets_dtype=torch.int32):
        offs = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        offs += first
        x = rng.standard_normal((int(offs[-1]), d)) * 50
        if dtype == torch.bool:
            v = torch.from_numpy(x > 0)
        elif dtype == torch.int64:
            v = torch.from_numpy(2**40 + x.astype(np.int64))
        else:
            v = torch.from_numpy(x.astype(np.float32)).to(dtype)
        return (v.to(dev), torch.from_numpy(offs).to(offsets_dtype).to(dev),
                max_len)

    over = [65, 200, 64, 1, 0, 130, 64, 500]
    flat = torch.from_numpy(rng.standard_normal(1024 * 4 + 1).astype(
        np.float32)).to(dev)
    return {
        "over-length rows": case(over, 8, torch.float32),
        "empty rows": case([0, 9, 0, 0, 70, 0], 4, torch.float32),
        "N == 0": case([0, 0, 0], 4, torch.float32),
        "B == 0": case([], 4, torch.float32),
        "bf16 D=1": case(over, 1, torch.bfloat16),
        "bf16 D=130": case(over, 130, torch.bfloat16, offsets_dtype=torch.int64),
        "int8 D=3": case(over, 3, torch.int8),
        "int64 D=1 above 2^31": case(over, 1, torch.int64),
        "bool D=5": case(over, 5, torch.bool),
        "offsets[0] = 7": case([9, 30, 0, 5], 64, torch.float16, first=7),
        "arena slice starting mid-line": (
            flat[1:].view(1024, 4), torch.tensor([0, 5, 300, 301, 1024],
                                                 device=dev), 256),
        "negative and past-the-end segments": (
            torch.arange(36, dtype=torch.float32, device=dev).view(12, 3),
            torch.tensor([0, 5, 2, 12, 15, -3, 1], device=dev), 6),
    }


def jagged_phase(jf) -> dict:
    """Each trait arena of the featurized batch, as its (N, 1) column over
    its plan's int64 offsets, through ``jagged_to_padded``: each equals
    ``to_padded()`` byte for byte. Then an (N, 128) float32 row block (NaN
    and -0.0 in it) and its bf16 copy over int32 offsets: each equals the
    plain version on the card, bit for bit. Those 6 launches are the
    phase's path; the edge cases and timings come after the count."""
    import numpy as np
    import torch

    from repro_torch.kernels.jagged import ops as jg

    dev = torch.device(DEVICE)
    b, l, n = jf.plan.b, jf.plan.seq_len, jf.plan.total
    rng = np.random.default_rng(SEED + 2)
    traits = {t: (torch.from_numpy(jf.values[t]).to(dev)[:, None],
                  torch.from_numpy(jf.plan_for(t).offsets).to(dev))
              for t in TRAITS}
    rows = torch.from_numpy(rng.standard_normal((n, D_SEQ)).astype(
        np.float32)).to(dev)
    rows[::97, 0] = math.nan
    rows[1::89, 1] = -0.0
    blocks = {"float32": rows, "bf16": rows.to(torch.bfloat16)}
    offs32 = torch.from_numpy(jf.offsets.astype(np.int32)).to(dev)
    torch.cuda.synchronize()

    jg.jagged_to_padded.launches = 0           # count this path only
    dense = {t: jg.jagged_to_padded(v, o, l) for t, (v, o) in traits.items()}
    padded = {k: jg.jagged_to_padded(v, offs32, l) for k, v in blocks.items()}
    torch.cuda.synchronize()
    launches = jg.jagged_to_padded.launches
    require(launches == len(TRAITS) + len(blocks),
            f"jagged_to_padded launched {launches} times, want "
            f"{len(TRAITS) + len(blocks)}")

    want = jf.to_padded()
    for t in TRAITS:
        same_bytes(dense[t][:, :, 0], want[f"uih_{t}"],
                   f"jagged_to_padded({t}) vs to_padded()")
    for k, v in blocks.items():
        same_bytes(padded[k], jg.jagged_to_padded_ref(v, offs32, l),
                   f"jagged_to_padded {k} block vs plain version")
    edge = jagged_edge_cases(rng, dev)
    for name, (v, o, ml) in edge.items():
        same_bytes(jg.jagged_to_padded(v, o, ml),
                   jg.jagged_to_padded_ref(v, o, ml),
                   f"jagged_to_padded {name}")
    err = 0                      # every output matched byte for byte
    widths = {name: jg.word_bytes(v, torch.empty((1, v.shape[1]),
                                                 dtype=v.dtype, device=dev))
              for name, (v, _, _) in edge.items() if v.numel()}
    ts_max = int(want["uih_timestamp"].max())
    say("kernel", f"jagged_to_padded over {b} featurized examples (L={l}, "
                  f"N={n}, fill {n / (b * l):.3f}): {len(TRAITS)} trait "
                  f"arenas ({', '.join(f'{t} {jf.values[t].dtype}' for t in TRAITS)}) "
                  f"== to_padded() byte for byte (uih_timestamp max {ts_max}); "
                  f"the (N, {D_SEQ}) float32 and bf16 blocks == plain version "
                  f"bit for bit; {len(edge)} edge cases == plain version: "
                  + ", ".join(f"{k} ({widths.get(k, 0)}-byte words)"
                              for k in edge)
                  + f"; {launches} launches on the path; max_abs_err {err}")

    rows32 = blocks["float32"]
    ms = cuda_ms(lambda: jg.jagged_to_padded(rows32, offs32, l))
    dev_ms = device_ms(lambda: jg.jagged_to_padded(rows32, offs32, l),
                       name="jagged_to_padded_kernel")
    plain_ms = cuda_ms(lambda: jg.jagged_to_padded_ref(rows32, offs32, l),
                       iters=50)
    plain_dev_ms = device_ms(
        lambda: jg.jagged_to_padded_ref(rows32, offs32, l), iters=50)
    row = D_SEQ * 4
    kept = int(np.minimum(np.diff(jf.offsets), l).sum())
    nbytes = kept * row + (b + 1) * 4 + b * l * row
    full = b * l * row + (b + 1) * 4 + b * l * row
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    yard = ""
    if hasattr(torch.ops.aten, "_jagged_to_padded_dense_forward"):
        left = torch.ops.aten._jagged_to_padded_dense_forward
        y_ms = cuda_ms(lambda: left(rows32, [offs32.long()], [l]))
        yard = (f"; for scale only, a different function (left-aligned, "
                f"keeps the first L rows): aten._jagged_to_padded_dense_"
                f"forward {y_ms:.6f} ms a call")
    say("kernel", f"jagged_to_padded B={b} L={l} D={D_SEQ} float32 at fill "
                  f"{kept / (b * l):.3f}: {ms:.6f} ms a call (device only "
                  f"{dev_ms:.6f} ms), plain version {plain_ms:.6f} ms a call "
                  f"(device only {plain_dev_ms:.6f} ms), bound "
                  f"{bound_ms:.6f} ms ({nbytes} bytes at 3.35 TB/s; bound by "
                  f"bytes; full rows {full} bytes, "
                  f"{full / HBM_BYTES_PER_S * 1e3:.6f} ms); library_ms: null "
                  f"(no PyTorch call computes the right-aligned tail){yard}")
    return {"name": "jagged_to_padded", "route": "cuda",
            "source": "src/repro_torch/kernels/jagged/csrc/"
                      "jagged_to_padded.cu",
            "replaces": "src/repro/kernels/jagged/jagged.py:36",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "plain_device_ms": plain_dev_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "library_device_ms": None}


# ---------------------------------------------------------------------------
# phase 4b: delta_decode over the featurized batch's timestamp lane
# ---------------------------------------------------------------------------

def timestamp_deltas(jf):
    """The padded timestamp lane as row deltas: (B, L) int64 deltas that are
    0 up to and at each row's first kept position, its first kept
    timestamp (the window base, (B,) int64), the lane and its mask."""
    import numpy as np

    want = jf.to_padded()
    ts = want["uih_timestamp"]
    plan = jf.plan_for("timestamp")
    b, l = ts.shape
    first = l - plan.lens
    mask = plan.mask
    deltas = np.zeros_like(ts)
    deltas[:, 1:] = ts[:, 1:] - ts[:, :-1]
    deltas[np.arange(l)[None, :] <= first[:, None]] = 0
    bases = np.where(plan.lens > 0, ts[np.arange(b), np.minimum(first, l - 1)],
                     0)
    return deltas, bases, ts, mask


def delta_decode_phase(jf) -> dict:
    """The batch's timestamp lane through ``delta_decode`` twice: as int64
    row deltas with epoch-millisecond bases (all above 2^31), which decode
    to ``to_padded()``'s timestamps on that clock under the mask, and as
    int32 window-relative deltas with zero bases, which decode to
    ``ts - base``. Those 2 launches are the phase's path; then every output
    and an int32 wrap, an int64 span above 2^33 and B=1024 are held to the
    plain version exactly, and the timings run."""
    import numpy as np
    import torch

    from repro_torch.kernels.delta_decode import ops as dd

    dev = torch.device(DEVICE)
    deltas, bases, ts, mask = timestamp_deltas(jf)
    b, l = deltas.shape
    d64 = torch.from_numpy(deltas).to(dev)
    b64 = torch.from_numpy(bases + EPOCH_MS).to(dev)
    require(int(b64.min()) > 2**31, "epoch bases not above 2^31")
    d32 = d64.to(torch.int32)
    z32 = torch.zeros(b, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()

    dd.delta_decode.launches = 0               # count this path only
    abs_ts = dd.delta_decode(d64, b64)
    rel_ts = dd.delta_decode(d32, z32)
    torch.cuda.synchronize()
    launches = dd.delta_decode.launches
    require(launches == 2, f"delta_decode launched {launches} times, want 2")

    got = abs_ts.cpu().numpy()
    require(got.dtype == np.int64 and np.array_equal(got[mask] - EPOCH_MS,
                                                     ts[mask]),
            "int64 decode differs from to_padded()'s timestamps")
    rel_want = (ts - bases[:, None]).astype(np.int32)
    require(np.array_equal(rel_ts.cpu().numpy()[mask], rel_want[mask]),
            "int32 window-relative decode differs from ts - base")
    rng = np.random.default_rng(SEED + 3)
    wide = torch.from_numpy(rng.integers(-2**40, 2**40, (b, l))).to(dev)
    wide[:, 1] = 2**33 + 7
    cases = {
        "int64 epoch timestamps": (d64, b64),
        "int32 window-relative": (d32, z32),
        "int32 wrap (2^30 deltas)": (torch.full_like(d32, 2**30), torch.full(
            (b,), 2**31 - 1, dtype=torch.int32, device=dev)),
        "int64 span above 2^33": (wide, b64),
        "mixed: int32 deltas, int64 epoch bases": (d32, b64),
        "B=1024 int32": (torch.from_numpy(rng.integers(
            -2**20, 2**20, (1024, l))).to(dev).int(), torch.from_numpy(
            rng.integers(-2**30, 2**30, 1024)).to(dev).int()),
    }
    for name, args in cases.items():
        same_bytes(dd.delta_decode(*args), dd.delta_decode_ref(*args),
                   f"delta_decode {name} vs plain version")
    require(torch.equal(dd.delta_decode(d32, b64), abs_ts),
            "mixed-width decode differs from the int64 decode")
    err = 0                      # every output matched exactly
    before = dd.delta_decode.launches
    for shape in ((0, l), (b, 0)):
        e = dd.delta_decode(torch.zeros(shape, dtype=torch.int32, device=dev),
                            torch.zeros(shape[0], dtype=torch.int32,
                                        device=dev))
        require(e.shape == shape and e.dtype == torch.int32, "empty decode")
    require(dd.delta_decode.launches == before, "an empty decode launched")
    say("kernel", f"delta_decode over the batch's timestamp lane (B={b}, "
                  f"N={l}): int64 row deltas + epoch bases (min "
                  f"{int(b64.min())}) == to_padded()'s timestamps + "
                  f"{EPOCH_MS} under the mask (max "
                  f"{int(abs_ts.max())}); int32 window-relative deltas == "
                  f"ts - base; {len(cases)} cases == plain version exactly: "
                  f"{', '.join(cases)}; empty shapes return without a launch;"
                  f" {launches} launches on the path; max_abs_err {err}")

    kernels_a_call(lambda: dd.delta_decode(d32, b64), "delta_decode_kernel",
                   "delta_decode with int32 deltas and int64 bases")

    def timed(d, bs, what):
        dt = torch.int64 if torch.int64 in (d.dtype, bs.dtype) else d.dtype

        def library():
            return torch.cumsum(d, 1, dtype=dt) + bs[:, None]

        require(torch.equal(library(), dd.delta_decode(d, bs)),
                f"torch.cumsum differs from delta_decode at {what}")
        t = dict(zip(("ms", "library_ms"), turns_ms(
            lambda: dd.delta_decode(d, bs), library)))
        t.update(device_ms=device_ms(lambda: dd.delta_decode(d, bs),
                                     name="delta_decode_kernel"),
                 plain_ms=cuda_ms(lambda: dd.delta_decode_ref(d, bs),
                                  iters=50),
                 plain_device_ms=device_ms(
                     lambda: dd.delta_decode_ref(d, bs), iters=50),
                 library_device_ms=device_ms(library))
        nbytes = (d.numel() * (d.element_size() + dt.itemsize)   # in, out
                  + bs.numel() * bs.element_size())
        t["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        say("kernel", f"delta_decode {what}: {t['ms']:.6f} ms a call (device "
                      f"only {t['device_ms']:.6f} ms), plain version "
                      f"{t['plain_ms']:.6f} ms a call (device only "
                      f"{t['plain_device_ms']:.6f} ms), torch.cumsum + base "
                      f"{t['library_ms']:.6f} ms a call (device only "
                      f"{t['library_device_ms']:.6f} ms), bound "
                      f"{t['bound_ms']:.6f} ms ({nbytes} bytes at 3.35 TB/s; "
                      f"bound by bytes)")
        return t

    main = timed(d32, z32, f"B={b} N={l} int32")
    timed(d64, b64, f"B={b} N={l} int64")
    timed(d32, b64, f"B={b} N={l} int32 deltas, int64 bases")
    timed(*cases["B=1024 int32"], f"B=1024 N={l} int32")

    launch = dd.LIBRARY.function("delta_decode_launch")
    for d, bs, what in ((d32, z32, "int32"),
                        (d32, b64, "int32 deltas, int64 bases")):
        out = dd.delta_decode(d, bs)
        args = (d.data_ptr(), d.stride(0), int(d.dtype == torch.int64),
                bs.data_ptr(), bs.stride(0), int(bs.dtype == torch.int64),
                b, l, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        host_split(f"delta_decode B={b} N={l} {what}",
                   lambda: dd.delta_decode(d, bs), launch, args,
                   lambda: torch.cumsum(d, 1, dtype=out.dtype) + bs[:, None],
                   "torch.cumsum + base",
                   lambda: d.new_empty((b, l), dtype=out.dtype), d)
    return {"name": "delta_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/delta_decode/csrc/"
                      "delta_decode.cu",
            "replaces": "src/repro/kernels/delta_decode/delta_decode.py:40",
            "launches": launches, "max_abs_err": err, "bound_by": "bytes",
            **main}


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


def main_path_phase(sim):
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


# ---------------------------------------------------------------------------
# phase 6: embedding_bag against its plain version on the card, on the FULL
# two-tower item table
# ---------------------------------------------------------------------------

def bag_inputs(rng, b, l, v, poison=False):
    """int64 ids and a right-aligned bool mask, as late_materialize hands
    them to embedding_bag. ``poison`` gives random lengths (row 0 fully
    masked) and puts ids past both ends of the table on the padded lanes;
    otherwise every position is valid."""
    import numpy as np
    import torch

    ids = rng.integers(0, v, (b, l))
    lens = rng.integers(0, l + 1, b) if poison else np.full(b, l)
    if poison and b:
        lens[0] = 0
    mask = np.arange(l)[None, :] >= (l - lens)[:, None]
    if poison:
        ids[~mask] = v + 1000
        ids[:, :1][~mask[:, :1]] = -7
    return (torch.from_numpy(ids).to(DEVICE),
            torch.from_numpy(mask).to(DEVICE))


def bag_err(got, want, rtol, atol, what):
    """max |got - want| in float32; raises beyond ``atol + rtol*|want|``."""
    import torch

    require(got.shape == want.shape and got.dtype == want.dtype,
            f"embedding_bag {what}: {tuple(got.shape)}/{got.dtype} vs "
            f"{tuple(want.shape)}/{want.dtype}")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    require(torch.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True),
            f"embedding_bag {what}: differs beyond rtol {rtol}, atol {atol} "
            f"(max abs err {err})")
    return err


def embedding_bag_phase(table):
    """Every edge case, then times at the serving shape (B=32, L=uih_len)
    and at the training history length (L=2048). Each timed call takes the
    next of several id sets, together larger than the 50 MB L2, so the
    gathered rows come from device memory as a server's would."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.two_tower_retrieval import FULL
    from repro_torch.kernels.embedding_bag import ops as eb

    v, d = table.shape
    rng = np.random.default_rng(SEED + 1)
    f32 = dict(rtol=1e-5, atol=1e-6)     # sum order differs
    bf16 = dict(rtol=1e-2, atol=1e-2)    # plain rounds per row, kernel once
    errs = {}

    def compare(name, tab, ids, mask, tol, combiners=("sum", "mean")):
        for c in combiners:
            got = eb.embedding_bag(tab, ids, mask, c)
            want = eb.embedding_bag_ref(tab, ids, mask, c)
            errs[f"{name} ({c})"] = bag_err(
                got, want, what=f"{name} ({c}) vs its plain version", **tol)

    l_main = FULL.uih_len
    compare(f"B={BATCH} L={l_main}, poisoned padding, a fully masked row",
            table, *bag_inputs(rng, BATCH, l_main, v, poison=True), f32)
    compare(f"B={BATCH} L={L_MAIN}", table,
            *bag_inputs(rng, BATCH, L_MAIN, v, poison=True), f32)
    compare("b=0", table, *bag_inputs(rng, 0, l_main, v), f32)
    compare("l=0", table, *bag_inputs(rng, 4, 0, v), f32)
    ids, mask = bag_inputs(rng, 7, 33, v, poison=True)
    w = mask * torch.rand(mask.shape, device=mask.device)
    compare("float weight mask", table, ids, w, f32)
    small = table[:min(v, 1_000_000)].to(torch.bfloat16)
    compare("bf16 table", small, *bag_inputs(rng, 9, l_main, len(small),
                                             poison=True), bf16)
    d100 = table[:100_000, :100].contiguous()
    compare("D=100", d100, *bag_inputs(rng, 5, 37, 100_000, poison=True),
            f32)
    compare("D=100 bf16", d100.to(torch.bfloat16),
            *bag_inputs(rng, 5, 37, 100_000, poison=True), bf16)
    ids, mask = bag_inputs(rng, BATCH, l_main, v, poison=True)
    compare("int32 ids", table, ids.int(), mask, f32)
    compare("bf16 weight mask", table, ids,
            (mask * torch.rand(mask.shape, device=mask.device)).to(
                torch.bfloat16), f32)
    wrapped = ids + torch.tensor([2**32, -(2**32), 3 * 2**32],
                                 device=ids.device).repeat(l_main)[:l_main]
    compare("int64 ids past +-2^32 (wrap, then clamp)", table, wrapped,
            mask, f32)
    f32_err = max(e for k, e in errs.items() if "bf16" not in k)
    say("kernel", f"embedding_bag == plain version on {len(errs)} cases "
                  f"(float32 within rtol 1e-5, atol 1e-6; bf16 within 1e-2) "
                  f"over the FULL item table {v} x {d} float32; max abs err "
                  + "; ".join(f"{k}: {e:.3e}" for k, e in errs.items()))

    ids, mask = bag_inputs(rng, BATCH, l_main, v)
    for c in ("sum", "mean"):
        kernels_a_call(lambda: eb.embedding_bag(table, ids, mask, c),
                       "embedding_bag_kernel", f"embedding_bag {c} with int64 "
                       f"ids and a bool mask (B={BATCH} L={l_main})")

    def timings(l, n_sets):
        sets = [bag_inputs(rng, BATCH, l, v) for _ in range(n_sets)]
        lib_sets = [(i.clamp(0, v - 1), m.to(table.dtype)) for i, m in sets]
        if l == l_main:   # the yardstick computes the same function
            (ids, mask), (cids, w) = sets[0], lib_sets[0]
            lib = F.embedding_bag(cids, table, mode="sum",
                                  per_sample_weights=w)
            bag_err(eb.embedding_bag(table, ids, mask), lib,
                    what="vs F.embedding_bag", **f32)

        def cycle(fn, args):
            it = itertools.cycle(args)
            return lambda: fn(*next(it))

        kernel = cycle(lambda i, m: eb.embedding_bag(table, i, m), sets)
        mean = cycle(lambda i, m: eb.embedding_bag(table, i, m, "mean"),
                     sets)
        plain = cycle(lambda i, m: eb.embedding_bag_ref(table, i, m), sets)
        library = cycle(lambda i, w: F.embedding_bag(
            i, table, mode="sum", per_sample_weights=w), lib_sets)
        t = dict(zip(("ms", "library_ms"), turns_ms(kernel, library)))
        t.update(device_ms=device_ms(kernel, name="embedding_bag_kernel"),
                 call_device_ms=device_ms(kernel), mean_ms=cuda_ms(mean),
                 plain_ms=cuda_ms(plain, iters=50),
                 plain_device_ms=device_ms(plain, iters=50),
                 library_device_ms=device_ms(library))
        nbytes = (BATCH * l * d * table.element_size()   # gathered rows
                  + BATCH * l * (8 + 1)                  # int64 ids, bool mask
                  + BATCH * d * table.element_size())    # output
        t["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        plan = eb.launch_plan(table, BATCH, l, eb.embedding_bag(table,
                                                               *sets[0]))
        say("kernel", f"embedding_bag B={BATCH} L={l} D={d} float32 (sum; "
                      f"clusters of {plan['cluster']} blocks a bag, "
                      f"{plan['vec']} values a load): "
                      f"{t['ms']:.6f} ms a call (device only "
                      f"{t['device_ms']:.6f} ms; every kernel the call "
                      f"launches {t['call_device_ms']:.6f} ms; mean "
                      f"{t['mean_ms']:.6f} ms a call), plain version "
                      f"{t['plain_ms']:.6f} ms a call (device only "
                      f"{t['plain_device_ms']:.6f} ms), F.embedding_bag "
                      f"{t['library_ms']:.6f} ms a call (device only "
                      f"{t['library_device_ms']:.6f} ms), bound "
                      f"{t['bound_ms']:.6f} ms ({nbytes} bytes at 3.35 TB/s; "
                      f"bound by bytes); {n_sets} id sets cycled")
        return t

    main = timings(l_main, 32)     # 32 x 3.3 MB of rows: past the L2
    timings(L_MAIN, 4)

    out = eb.embedding_bag(table, ids, mask)
    args = (table.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
            BATCH, l_main, d, v, 0, 1, 0, 0,   # float32, int64 ids, bool, sum
            torch.cuda.current_stream(table.device).cuda_stream)
    cids, w = ids.clamp(0, v - 1), mask.to(table.dtype)
    host_split(f"embedding_bag B={BATCH} L={l_main} D={d} float32 (sum, "
               f"int64 ids, bool mask)",
               lambda: eb.embedding_bag(table, ids, mask),
               eb.LIBRARY.function("embedding_bag_launch"), args,
               lambda: F.embedding_bag(cids, table, mode="sum",
                                       per_sample_weights=w),
               "F.embedding_bag", lambda: table.new_empty((BATCH, d)), table)
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                      "embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:57",
            "max_abs_err": f32_err, "bound_by": "bytes", **main}


# ---------------------------------------------------------------------------
# phase 7: the serving path — FULL two-tower retrieval behind RetrievalServer
# ---------------------------------------------------------------------------

def two_tower_params():
    import torch

    from repro_torch.configs.two_tower_retrieval import FULL
    from repro_torch.models import recsys as R

    t0 = time.perf_counter()
    params = R.init_two_tower(FULL, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    require(n == FULL.param_count(), f"{n} parameters, config says "
                                     f"{FULL.param_count()}")
    say("serve", f"FULL two-tower params on the card in "
                 f"{time.perf_counter() - t0:.3f} s: {n} float32 (embed "
                 f"{FULL.embed_dim}, towers {FULL.tower_mlp}, item vocab "
                 f"{FULL.item_vocab}, user vocab {FULL.user_vocab}, uih_len "
                 f"{FULL.uih_len}, {FULL.compute_dtype})")
    return params


def serve_wave(server, now, users):
    """Submit every request at once; returns the results and the latency of
    each (``done_t - enqueue_t``)."""
    import numpy as np

    pend = [server.submit(u, now, k=TOP_K) for u in users]
    res = [p.result(timeout=300.0) for p in pend]
    return res, np.array([p.done_t - p.enqueue_t for p in pend])


def check_top_k(index, scored) -> int:
    """For every row of the recorded ``top_k`` calls (padded rows too): the
    scores equal u.e of the returned ids, do not increase down the list, and
    no other candidate scores above the k-th (ties: lower index first)."""
    import numpy as np
    import torch

    emb = index.matrix()
    checked = 0
    for user_mat, ids, scores in scored:
        u = torch.from_numpy(user_mat).to(emb.device).to(emb.dtype)
        full = (u @ emb.T).float()          # the same product top_k takes
        for i in range(len(user_mat)):
            pos = torch.from_numpy(np.searchsorted(index.item_ids, ids[i])
                                   ).to(emb.device)
            s = torch.from_numpy(scores[i]).to(emb.device)
            require(torch.equal(full[i, pos], s), "returned scores differ "
                                                  "from the index's product")
            dots = (u[i].float() * emb[pos].float()).sum(-1)
            # the product's output is rounded to bf16: 2^-8 of |s| <= 1
            require(torch.allclose(dots, s, rtol=0, atol=1e-2),
                    f"scores differ from u.e: {(dots - s).abs().max()}")
            require(bool((s[1:] <= s[:-1]).all()), "scores increase")
            rest = full[i].clone()
            rest[pos] = -math.inf
            kth = s[-1]
            require(bool(rest.max() <= kth), "a candidate left out scores "
                                             "above the k-th")
            tied = torch.nonzero(rest == kth).flatten()
            if tied.numel():
                require(int(tied.min()) > int(pos[s == kth].max()),
                        "a tie at the k-th came out of index order")
            checked += 1
    return checked


def score_profile(index, user_mat) -> None:
    """Where a ``top_k`` call's time goes: the wall time of a call and the
    device kernels of 5 calls on one recorded batch, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls = 5
    index.top_k(user_mat, TOP_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            index.top_k(user_mat, TOP_K)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    require(bool(kernels), "the profiler saw no device time in top_k")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    say("score", f"top_k of {len(user_mat)} rows over {len(index)} items, "
                 f"k={TOP_K}: {wall_ms:.3f} ms a call, device kernels "
                 f"{busy_ms:.3f} ms a call (profiler, {calls} calls)")
    for e in kernels[:6]:
        say("score", f"{e.self_device_time_total / 1e3 / calls:10.3f} "
                     f"ms/call x{e.count / calls:<4g} {e.key[:100]}")


def serve_phase(sim, params):
    """The same request mix through a cache-off server and a cache-on server
    (two waves) over one index. Returns the histories the cache-off server
    materialized, by user: ``{user_id: (example, uih)}``."""
    import numpy as np
    import torch

    from repro_torch.configs.two_tower_retrieval import FULL
    from repro_torch.serve import CandidateIndex, RetrievalServer, ServeConfig

    index = CandidateIndex(FULL, device=DEVICE)
    t0 = time.perf_counter()
    index.refresh(params)
    say("serve", f"index refresh over {len(index)} items in "
                 f"{time.perf_counter() - t0:.3f} s (chunks of "
                 f"{index.batch_size}): {index.matrix().nbytes} B of "
                 f"{index.matrix().dtype}")
    scored = []
    real_top_k = index.top_k

    def recording_top_k(user_mat, k):
        ids, scores = real_top_k(user_mat, k)
        scored.append((user_mat, ids, scores))
        return ids, scores

    index.top_k = recording_top_k
    now = max(e.request_ts for e in sim.examples)
    seq = sorted({e.user_id for e in sim.examples})
    users = (seq * (SERVE_REQUESTS // len(seq) + 1))[:SERVE_REQUESTS]

    def server(**kw):
        return RetrievalServer.from_sim(
            sim, params, FULL, index=index, device=DEVICE, cfg=ServeConfig(
                lookback_ms=sim.cfg.lookback_ms, max_batch=SERVE_BATCH,
                n_workers=1, default_k=TOP_K, **kw))

    def leak_free(srv, what):
        require(srv.stats.failed_requests == 0,
                f"{what}: {srv.stats.failed_requests} failed requests")
        leased = sim.immutable.leased_generations()
        require(leased == {}, f"{what}: leased generations {leased} after "
                              f"close()")

    def report(srv, what, waves):
        st = srv.stats
        spans = {k: np.mean([sp["stages"][k][1] - sp["stages"][k][0]
                             for sp in srv.spans])
                 for k in ("scan", "featurize", "encode", "score")}
        lat = "; ".join(f"wave {i + 1}: {len(lt)} requests in {wall:.3f} s, "
                        f"p50 {np.percentile(lt, 50) * 1e3:.3f} ms, p99 "
                        f"{np.percentile(lt, 99) * 1e3:.3f} ms"
                        for i, (lt, wall) in enumerate(waves))
        say("serve", f"{what}: {st.requests} answered in {st.batches} "
                     f"batches, cold {st.cold_requests}, cached "
                     f"{st.cached_requests}, failed {st.failed_requests}, "
                     f"padded rows {st.padded_rows}; {lat}; mean seconds a "
                     f"batch: " + ", ".join(f"{k} {v:.6f}"
                                            for k, v in spans.items()))

    torch.cuda.reset_peak_memory_stats()
    histories = {}
    off = server(cache_capacity=0, window_cache_size=0)
    real_mat = off.materializer.materialize_batch

    def recording_materialize(examples, projection=None):
        uihs = real_mat(examples, projection)
        for ex, uih in zip(examples, uihs):
            histories.setdefault(ex.user_id, (ex, uih))
        return uihs

    off.materializer.materialize_batch = recording_materialize
    t0 = time.perf_counter()
    want, lat = serve_wave(off, now, users)
    wall = time.perf_counter() - t0
    off.close()
    leak_free(off, "cache off")
    require(off.stats.cold_requests == len(users), "cache-off server used "
                                                   "a cache")
    report(off, "cache off", [(lat, wall)])
    index.top_k = real_top_k
    n = check_top_k(index, scored[:4])
    say("serve", f"{n} rows of the first {min(4, len(scored))} top_k calls "
                 f"(padded rows included): scores == u.e of the returned ids "
                 f"(bf16 product, atol 1e-2), non-increasing, no other "
                 f"candidate above the k-th, ties in index order")

    on = server()
    waves, got = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        res, lat = serve_wave(on, now, users)
        waves.append((lat, time.perf_counter() - t0))
        got.append(res)
    on.close()
    leak_free(on, "cache on")
    report(on, "cache on", waves)
    require(on.stats.cached_requests > 0 and all(r.cached for r in got[1]),
            "the second wave did not come from the cache")
    for res in got:
        for a, b in zip(want, res):
            require(a.item_ids.tobytes() == b.item_ids.tobytes()
                    and a.scores.tobytes() == b.scores.tobytes(),
                    f"cache-on result for user {a.user_id} differs from "
                    f"cache-off")
    peak = torch.cuda.max_memory_allocated()
    say("serve", f"cache on == cache off byte for byte over "
                 f"{len(got) * len(users)} requests; peak memory {peak} B")
    score_profile(index, scored[0][0])
    return histories


# ---------------------------------------------------------------------------
# phase 8: late_materialize over the served users' histories
# ---------------------------------------------------------------------------

def late_materialize_phase(histories, table) -> dict:
    """``BATCH`` served users' histories -> featurize_jagged ->
    late_materialize on the server's item table (mean bag). Returns the
    launches of each kernel in that one call."""
    import torch

    from repro_torch.configs.two_tower_retrieval import FULL
    from repro_torch.dpp.featurize import FeatureSpec, featurize_jagged
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.fused import ops
    from repro_torch.models.embedding import embedding_bag

    users = sorted(histories)[:BATCH]
    require(len(users) == BATCH, f"{len(users)} served users, need {BATCH}")
    l = FULL.uih_len
    jf = featurize_jagged([histories[u][0] for u in users],
                          [histories[u][1] for u in users],
                          FeatureSpec(seq_len=l,
                                      uih_traits=("item_id", "timestamp")))

    def call():
        return ops.late_materialize(jf.values, jf.offsets, l,
                                    ts_trait="timestamp", table=table,
                                    ids_trait="item_id", combiner="mean",
                                    device=DEVICE)

    ops.fused_densify.launches = 0          # count this path only
    eb.embedding_bag.launches = 0
    out = call()
    torch.cuda.synchronize()
    launches = {"fused_densify": ops.fused_densify.launches,
                "embedding_bag": eb.embedding_bag.launches}
    require(launches == {"fused_densify": 1, "embedding_bag": 1},
            f"late_materialize launched {launches}, want one of each")
    want = jf.to_padded()
    pairs = {"uih_len": out["lens"], "uih_mask": out["mask"],
             "uih_item_id": out["traits"]["item_id"],
             "uih_timestamp": out["traits"]["timestamp"]}
    for k, t in pairs.items():
        got = t.cpu().numpy()
        require(got.dtype == want[k].dtype and got.shape == want[k].shape
                and got.tobytes() == want[k].tobytes(),
                f"late_materialize {k} differs from to_padded()")
    ids, mask = pairs["uih_item_id"], pairs["uih_mask"]
    plain = eb.embedding_bag_ref(table, ids, mask, "mean")
    err = bag_err(out["pooled"], plain, rtol=1e-5, atol=1e-6,
                  what="in late_materialize vs its plain version")
    tower = embedding_bag(table, torch.from_numpy(want["uih_item_id"]).to(
        table.device), torch.from_numpy(want["uih_mask"]).to(table.device),
        "mean")
    err_tower = bag_err(out["pooled"], tower, rtol=1e-5, atol=1e-6,
                        what="vs the user tower's bag")
    ms = cuda_ms(call, iters=50)
    fill = float(want["uih_len"].mean() / l)
    say("late", f"late_materialize over {BATCH} served users (L={l}, fill "
                f"{fill:.3f}, uih_timestamp max "
                f"{int(want['uih_timestamp'].max())}): traits, lens and mask "
                f"== to_padded() byte for byte (timestamps exact int64); "
                f"pooled == embedding_bag_ref (max abs err {err:.3e}) and == "
                f"the user tower's float32 mean bag (max abs err "
                f"{err_tower:.3e}); one fused_densify + one embedding_bag "
                f"launch; {ms:.6f} ms a call (host packing included)")
    return launches


def build_kernels() -> None:
    """Build every kernel library at once: one nvcc a source, all started
    together (each ``lib()`` waits on its own subprocess)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.delta_decode import ops as dd
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.fused import ops
    from repro_torch.kernels.jagged import ops as jg

    def timed_build(lib):
        t0 = time.perf_counter()
        lib.lib()
        return time.perf_counter() - t0

    libs = (ops.LIBRARY, eb.LIBRARY, jg.LIBRARY, dd.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        seconds = list(pool.map(timed_build, libs))
    for lib, s in zip(libs, seconds):
        ptxas = [ln.strip() for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        say("build", f"{lib.path.name} built in {s:.3f} s into "
                     f"{build.BUILD_DIR}; ptxas: "
                     f"{' | '.join(ptxas) or 'cached build'}")
    say("build", f"{len(libs)} libraries in {time.perf_counter() - t0:.3f} s")


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

    build_kernels()
    densify = densify_phase()
    model_check_phase()
    t0 = time.perf_counter()
    sim = build_sim()
    say("main", f"sim built in {time.perf_counter() - t0:.3f} s: "
                f"{len(sim.examples)} examples")
    t0 = time.perf_counter()
    jf = featurized_batch(sim)
    jagged = jagged_phase(jf)
    delta = delta_decode_phase(jf)
    say("kernel", f"standalone kernel phases (featurize, checks, timings) in "
                  f"{time.perf_counter() - t0:.3f} s")
    densify["launches"] = main_path_phase(sim)
    # the training path's parameters, optimizer state and feed died with
    # main_path_phase; hand their memory back before the serving tier's
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    require(left < 2**30, f"{left} B still allocated after training")
    say("release", f"training tensors released: {left} B still allocated")
    torch.cuda.reset_peak_memory_stats()

    params = two_tower_params()
    table = params["item_table"].detach()
    bag = embedding_bag_phase(table)
    histories = serve_phase(sim, params)
    late = late_materialize_phase(histories, table)
    bag["launches"] = late["embedding_bag"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in (densify, bag, jagged, delta)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
