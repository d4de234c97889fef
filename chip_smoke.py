#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. It builds every CUDA kernel from ``src/repro_torch``
into ``build/`` (one nvcc a source, all at once), holds each kernel against
its plain PyTorch version on the card (``fused_densify`` first: at the main
path's B=32 and at B=1024, L=2048, and on edge cases that make its plan
take each cluster size and each lane path; one device kernel a call, times
against the bound, the split of a call's host time), and drives the port's
paths over one ``ProductionSim``:

0a. AdamW: the multi-tensor AdamW kernel (``kernels/adamw``) over FULL
   DLRM-UIH's and FULL DCN-v2's own leaves, with gradients drawn on the
   card: 2 steps held against its plain per-leaf version (each element
   within limits that scale with its array, each parameter leaf's error
   norm against its change), then timed (device only and a call) beside the
   plain version, ``torch.optim.AdamW(fused=True)`` (the yardstick; the port
   never calls it) and the bound of 32 B a parameter, with the kernel's
   launch counters.
0b. The grouped expert product (``kernels/grouped_gemm``) at the
   DeepSeek-V2-Lite cell's shapes: each form held against its plain version
   over even and uneven group loads, then timed beside its bound, the plain
   version and ``torch._grouped_mm`` (the yardstick); then one full-width
   dropless MoE layer of that cell, forward and backward through
   ``moe.moe_dropless``, with its 6 launches counted and its output and
   gradients held against the same layer through the plain version.
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
   batches; every step makes the AdamW kernel's two launches (the kernels'
   table gives this path's count). Its tensors are then released.
1a. Tenants: FULL DCN-v2, DIEN and BERT4Rec (``configs/{dcn_v2,dien,
   bert4rec}.FULL``), each trained ``TENANT_STEPS`` AdamW steps by
   ``Trainer.fit`` from its own ``open_feed(device_materialize=True)`` at its
   own length and traits (DIEN and DCN-v2 at L=100 with item ids and
   categories, BERT4Rec at L=200 with item ids), so ``fused_densify`` runs
   at their (L, T) behind the real feed; each held to the main path's feed
   checks, its kernel timed at that shape, a 512-row forward pass served,
   and one user scored against 1,000,000 candidates, 16 of them held
   against ``*_forward``; then a fresh FULL DLRM-UIH scores an L=2048 user
   against 1,000,000 candidates. Its tensors are then released.
1b. Stream: the same model trained by ``Trainer.fit`` from a live stream
   over a second, generation-pinned sim, across the backfill -> live flip,
   while a producer thread runs the live days and a seeded ``FaultPlan``
   disconnects the stream, crashes workers and compacts under their scans:

     warehouse replay -> flip (request-id watermark) -> live micro-batches
     -> DPP workers (host densify, checksum audit) -> DevicePrefetcher
     -> Trainer.fit, until the stream drains

   It requires each example of the range trained exactly once, the trained
   windows clean under ``audit_streaming``, every lease released, each
   fault healed and no ``fused_densify`` launch (the reference densifies
   streamed batches on the host), and prints steps/s, freshness,
   starvation and H2D bytes. Its tensors are then released.
1c. Entry: the reference's entry points on the port. The five examples
   run as a user runs them, ``python3 examples_torch/<name>.py`` with
   ``PYTHONPATH=src``, as subprocesses side by side, each held by the
   lines it prints: ``train_seqrec`` 60 steps (the loss falls), resumed
   from its step-50 checkpoint to 70, then FULL DLRM-UIH
   (``--config full``) 20 steps with its steps/s and peak;
   ``train_streaming`` (1 history and 1 live day: each example once,
   every lease released), ``serve_retrieval`` (512 requests, no leaked
   lease), ``streaming_vs_batch`` (0 feature mismatches, equal scores)
   and ``quickstart`` (O2O-exact, no leakage). Then the sixteen
   benchmarks of ``benchmarks_torch.run.MODULES`` in this process, in
   that order, through ``run_module``, the four kernels' counts set to 0
   just before each, each launching the kernels it reaches and no other:
   the eleven host benchmarks (``fig2_cost_wall``,
   ``table1_system_efficiency``, ``bench_prefetch``, ``bench_affinity``,
   ``bench_scan_plan``, ``bench_rebatch``, ``bench_multitenant``,
   ``bench_sharded_store``, ``bench_failover``, ``bench_streaming``,
   ``bench_chaos``) at their full configs with their own asserts met
   (byte identity, no lost examples, the pending replay) and no kernel
   launched; ``bench_kernels`` and ``bench_device_mat`` at their full
   configs (``exact_match`` and byte identity); ``bench_feed``,
   ``bench_serve`` and ``fig4_ne_scaling`` quick. Each ``BenchResult``
   line is printed.
1d. Cells: the launch layer's 44 (arch x shape) cells at FULL on the
   one-card mesh (``launch.mesh.make_test_mesh(1)``): the 20 recsys cells
   and the 24 LM/GNN zoo cells. A dry run starts on the host's CPU, one
   subprocess an arch: ``--mesh one`` reckons each cell's peak, its eager
   traffic and its floor (compulsory bytes and model FLOPs) from a
   fake-tensor trace of its step. Meanwhile a FULL
   DLRM-UIH feed opened with the train cell's placements
   (``open_feed(cell=, mesh=)``) is held against the plain feed: its
   ``fused_densify`` launches and its batches byte for byte. Every cell
   whose reckoned peak is under ``CELL_PEAK_LIMIT`` then runs at its own
   shape (``launch.sampling.sample_args``, 2 warm-up calls, 3 timed train
   or 10 other calls): finite outputs, a loss that changes and an advanced
   optimizer step for train cells, N scores for retrieval cells, a call no
   faster than its floor; ms a call, the step's peak beside the reckoned
   one, ``model_flops``, MFU, the floor and the eager traffic.
1e. Zoo: the five LMs (Qwen3-4B and -8B, Granite-8B, Qwen3-30B-A3B,
   DeepSeek-V2-Lite) served at FULL width and depth in bf16, weights drawn
   on the card leaf by leaf: ``prefill`` of 4 prompts of 2048 tokens, the
   cache padded to 2080 positions, 32 greedy ``decode_step``s, and the
   last step's logits held against ``prefill`` over the 2080 tokens. Then
   Qwen3-4B (12 of 36 layers) and DeepSeek-V2-Lite (3 of 27: MLA and MoE
   backward) trained 5 AdamW steps at FULL width, seq 4096, batch 1. Each
   model's tensors are released before the next.
1f. Mesh: the same five LMs at FULL width, cut to 2 layers, serve their
   ``prefill_32k`` (batch 2, seq cut to 4096), ``decode_32k`` (batch 2,
   the full 32,768-position cache, one step) and ``long_500k`` (batch 1,
   the full 524,288-position cache over all ranks, one step) cells as the
   rank-local programs of a (2, 16) ``("data", "model")`` mesh whose 32
   ranks are threads of this process on the card
   (``launch.threaded.ThreadedMesh``): each rank's block from
   ``launch.sampling.local_args``, its cell's ``step_fn``, the logits
   gathered from the vocabulary blocks and each rank's cache block held
   against the single-device program on the same weights, cache and
   tokens, in float32 compute over the bf16 weights at a capacity no MoE
   pair exceeds (relative Frobenius <= 1e-3; the entries the call did not
   write unchanged) and in the cells' own bf16 (reported). Meanwhile the
   production dry runs (16x16 and 2x16x16 fake meshes, one subprocess an
   arch and mesh) must end ok for all 88 cells, each zoo cell's per-chip
   peak and bound printed; ``benchmarks_torch.roofline_report`` then
   renders their tables for ``pod`` and ``multipod``: one roofline row
   for each cell, and three hillclimb picks, printed.
1g. Mesh train: the train cells' rank-local steps, whose backward crosses
   ranks, on a (2, 2) ``("data", "model")`` mesh of 4 rank processes that
   share the card (``launch.procmesh.ProcessMesh``: one CUDA context and
   autograd engine a rank, collectives through card buffers the ranks
   map). Each cell at FULL width in float32 compute with TF32 off and
   deterministic kernels (the MoEs at a capacity no pair exceeds), cut
   where one card does not hold it (``MESH_TRAIN_CELLS``): its one-rank
   AdamW steps on the one-card mesh first (their states kept on the card,
   or in host memory for the cells too large for that), then the same 2
   steps in the 4 ranks on the same parameters and batches, each rank
   cutting its blocks (``testing.mesh_train``); the global loss and
   gradient norm held to 1e-4 relative, every first-moment leaf to 1e-3
   relative Frobenius, and every parameter leaf to 1e-3 once the elements
   whose Adam direction flipped on a near-zero gradient (no larger than
   the ranks' largest gradient difference) are counted apart. DLRM-UIH
   (batch 32) takes its batches from the cell-placed feed opened in every
   rank over its own copy of an 8-user sim, so ``fused_densify`` launches
   in every rank; then the four other ranking tenants' ``train_batch``,
   the five LMs' ``train_4k`` (2 layers) and three MeshGraphNet shapes at
   full depth. One line a cell: each step's errors and worst leaves, ms
   a step (a rank process's, not a per-chip time), each rank's peak.
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
path, the entry points that launched it, error against the plain version,
times and bound), and the last line
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
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


TRACE_ATTEMPTS = 8         # traces of a window before its CUDA-event time


def traced_kernels(fn, iters: int, name: str = "",
                   attempts: int = TRACE_ATTEMPTS) -> dict:
    """``{kernel name: (records, device us)}`` of the device kernels that
    ``iters`` calls of ``fn`` launch, from a ``torch.profiler`` trace (one
    warm-up cycle with tracing already on, so the counted cycle starts with
    the device tracer running), with the window's CUDA-event time and the
    records kept: ``(found, window_ms a call, kept)``. The trace drops
    records now and then, once in a while all of them, and now and then a
    record of the warm-up cycle lands in the counted one: a trace that
    keeps fewer records than calls of its busiest kernel whose name
    contains ``name``, or (for a ``name``) more, is taken again, up to
    ``attempts`` traces in all; the most complete one is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    best = None
    for attempt in range(attempts):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            for counted, n_calls in ((False, 10), (True, iters)):
                if counted:
                    start.record()
                for _ in range(n_calls):
                    fn()
                if counted:
                    end.record()
                torch.cuda.synchronize()
                prof.step()
        window_ms = start.elapsed_time(end) / iters
        found = {e.key: (e.count, e.self_device_time_total)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.count}
        named = [n for k, (n, _) in found.items() if name in k]
        kept = max(named, default=0)
        over = bool(name) and kept > iters
        if best is None or (not over and (best[3] or kept > best[2])):
            best = (found, window_ms, kept, over)
        if kept >= iters and not over:
            break
        say("trace", f"trace {attempt + 1} of {attempts} kept {kept} "
                     f"records of {name or 'its busiest kernel'} over "
                     f"{iters} calls ({sum(n for n, _ in found.values())} "
                     f"in all)"
                     + ("; tracing again" if attempt + 1 < attempts else ""))
    return best[:3]


def device_ms(fn, iters: int = 200, name: str = "") -> float:
    """Device time per call of the kernels ``fn`` launches whose name
    contains ``name`` (all of them for ""), read from ``traced_kernels``:
    kernel durations only, no host dispatch. Where no trace kept a record
    a call, the time is the window's CUDA-event time (device and the host's
    gaps: an upper bound), said so on the ``[trace]`` line beside the
    records kept.

    A call's time is, for each distinct kernel, its mean traced duration
    times the launches it makes a call (its traced count over ``iters``,
    rounded; one for the kernel ``name`` names)."""
    found, window_ms, kept = traced_kernels(fn, iters, name)
    found = {k: v for k, v in found.items() if name in k}
    if kept < iters:
        say("trace", f"{name or 'every kernel'}: {kept} records kept over "
                     f"{iters} calls in {TRACE_ATTEMPTS} traces; "
                     f"{window_ms:.6f} ms a call from the window's CUDA "
                     f"events")
        return window_ms
    n = sum(c for c, _ in found.values())
    require(not name or n <= iters,
            f"{n} {name} kernels traced for {iters} calls")
    per_call = [(us / c, round(c / iters) or int(bool(name)))
                for c, us in found.values()]
    ms = sum(us * k for us, k in per_call) / 1e3
    say("trace", f"{name or 'every kernel'}: {n} records kept over {iters} "
                 f"calls, {sum(k for _, k in per_call)} launches a call, "
                 f"{ms:.6f} ms a call (window, CUDA events: "
                 f"{window_ms:.6f} ms)")
    return ms


def kernels_a_call(fn, name: str, what: str, iters: int = 50) -> None:
    """Require that each call of ``fn`` launches exactly one device kernel,
    ``name``: every kernel a trace of ``iters`` calls records
    (``traced_kernels``) bears that name, and their count over ``iters``
    rounds to 1 (the trace may drop a record, never add one). Prints the
    count."""
    found = traced_kernels(fn, iters, name)[0]
    n = sum(c for c, _ in found.values())
    per_call = round(n / iters)
    require(all(name in k for k in found) and n <= iters and per_call == 1,
            f"{what}: want one {name} a call, traced "
            f"{ {k: c for k, (c, _) in found.items()} } over {iters} calls")
    say("kernel", f"{what}: {per_call} device kernel a call ({n} records of "
                  f"{name} kept over {iters} calls, no other kernel)")


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
               alloc, like) -> dict:
    """Where a wrapper call's host time goes: (i) the wrapper's whole
    enqueue, (ii) the cached C function alone on arguments prepared
    beforehand (the ctypes call and the launch), (iii) the library
    yardstick's enqueue (none when ``library`` is None); and, inside
    (i) - (ii), the outputs' allocation ``alloc`` and the stream handle by
    the two candidates, for the card of the tensor ``like``. Returns the
    times in microseconds."""
    import torch

    dev, idx = like.device, like.get_device()
    t = {"wrapper_us": host_us(wrapper),
         "c_us": host_us(lambda: c_fn(*c_args)),
         "library_us": host_us(library) if library else None,
         "alloc_us": host_us(alloc),
         "stream_current_us": host_us(
             lambda: torch.cuda.current_stream(dev).cuda_stream),
         "stream_raw_us": host_us(
             lambda: torch._C._cuda_getCurrentRawStream(idx))}
    say("host", f"{what}: (i) wrapper {t['wrapper_us']:.3f} us a call; (ii) "
                f"cached C function alone {t['c_us']:.3f} us; (i) - (ii), the "
                f"wrapper's Python, {t['wrapper_us'] - t['c_us']:.3f} us, of "
                f"which the outputs' new_empty {t['alloc_us']:.3f} us and the "
                f"stream handle {t['stream_raw_us']:.3f} us "
                f"(torch._C._cuda_getCurrentRawStream; torch.cuda."
                f"current_stream(device).cuda_stream {t['stream_current_us']:.3f}"
                f" us); (iii) "
                + (f"{lib_name} {t['library_us']:.3f} us" if library
                   else "no library call computes this function")
                + " (perf_counter_ns, 2000 calls, no synchronise in a loop)")
    return t


# ---------------------------------------------------------------------------
# phase 3: fused_densify against its plain version on the card
# ---------------------------------------------------------------------------

def densify_case(rng, b, seq_len, lens, ts0=None, float_lane=False,
                 traits=("item_id", "action_type", "category")):
    """A packed (arena, offsets, bases, ts_col) case from numpy, laid out as
    the main path's payloads: of ``traits``, int64 item ids and int32 lanes,
    optionally a float32 lane, and a delta-encoded timestamp column from
    ``ts0`` on."""
    import numpy as np

    from repro_torch.kernels.fused import ops

    offs = np.zeros(b + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    n = int(offs[-1])
    vals = {"item_id": rng.integers(0, 10_000_000, n).astype(np.int64),
            "action_type": rng.integers(0, 16, n).astype(np.int32),
            "category": rng.integers(0, 1_000, n).astype(np.int32)}
    vals = {k: vals[k] for k in traits}
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


def card_args(case, seq_len, ts=True):
    """``fused_densify``'s arguments for a packed case on the card;
    ``ts=False`` reads its timestamp column as a plain lane."""
    import torch

    arena, offs, bases, ts_col = case
    dev = torch.device(DEVICE)
    on = ts and ts_col >= 0
    return (torch.from_numpy(arena).to(dev), torch.from_numpy(offs).to(dev),
            seq_len, torch.from_numpy(bases).to(dev) if on else None,
            ts_col if on else -1)


def kernel_vs_plain(args) -> int:
    """Run the kernel twice and the plain version on the same card tensors:
    all three outputs must be identical. Returns the max abs error (0)."""
    import torch

    from repro_torch.kernels.fused import ops

    got = ops.fused_densify(*args)
    again = ops.fused_densify(*args)
    want = ops.fused_densify_ref(*args)
    torch.cuda.synchronize()
    err = 0
    for g, a, w in zip(got, again, want):
        require((g is None) == (w is None) == (a is None),
                "kernel/plain outputs differ")
        if g is None:
            continue
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"kernel output {g.shape}/{g.dtype} vs plain "
                f"{w.shape}/{w.dtype}")
        require(torch.equal(g, a), "fused_densify differs run to run")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    require(err == 0, f"fused_densify disagrees with its plain version: "
                      f"max abs err {err}")
    return err


def densify_shapes():
    """The timed shapes' packed cases, from ``SEED``: the main path's
    (B=32, L=2048, 4 traits, timestamps from 3e9 on, rows from empty
    through over-length) and B=1024 at fill near 0.75, bound by bytes."""
    import numpy as np

    L = 2048
    rng = np.random.default_rng(SEED)
    lens = rng.integers(0, 2 * L, BATCH)
    lens[:3] = (0, L, 3 * L)
    big = rng.integers(0, 2 * L, 1024)
    return {f"B={BATCH}": (densify_case(rng, BATCH, L, lens,
                                        ts0=3_000_000_000), lens),
            "B=1024": (densify_case(rng, 1024, L, big, ts0=3_000_000_000),
                       big)}


def densify_bound_ms(case, lens, seq_len) -> float:
    """The least time for a call on this case: each kept arena row, the
    offsets and (with a timestamp lane) the bases read once, the int32
    block and the int64 timestamps written once, at 3.35 TB/s."""
    import numpy as np

    arena, offs, bases, ts_col = case
    b, t = len(lens), arena.shape[1]
    kept = int(np.minimum(lens, seq_len).sum())
    nbytes = kept * t * 4 + (b + 1) * 4 + b * seq_len * t * 4
    if ts_col >= 0:
        nbytes += b * 8 + b * seq_len * 8
    return nbytes / HBM_BYTES_PER_S * 1e3


def densify_timings(shapes=None, windows: int = 6) -> dict:
    """``fused_densify``'s times at each of ``densify_shapes``: a call (the
    median of ``windows`` windows of 200 back-to-back calls), device only
    with timestamps on and off (``torch.profiler``), and the bound. Uses
    only the wrapper and its plain version, so it times whichever
    ``repro_torch`` is first on ``sys.path``."""
    import statistics

    from repro_torch.kernels.fused import ops

    out = {}
    for name, (case, lens) in (shapes or densify_shapes()).items():
        args = card_args(case, 2048)
        off = card_args(case, 2048, ts=False)
        kernel_vs_plain(args)
        t = {"ms": statistics.median(
                 cuda_ms(lambda: ops.fused_densify(*args))
                 for _ in range(windows)),
             "device_ms": device_ms(lambda: ops.fused_densify(*args),
                                    name="fused_densify_kernel"),
             "ts_off_device_ms": device_ms(lambda: ops.fused_densify(*off),
                                           name="fused_densify_kernel"),
             "bound_ms": densify_bound_ms(case, lens, 2048)}
        say("kernel", f"fused_densify {name} L=2048 T=4: {t['ms']:.6f} ms a "
                      f"call (median of {windows} windows), device only "
                      f"{t['device_ms']:.6f} ms (timestamps off "
                      f"{t['ts_off_device_ms']:.6f} ms), bound "
                      f"{t['bound_ms']:.6f} ms (bytes at 3.35 TB/s)")
        out[name] = t
    return out


def densify_edge_cases(rng):
    """name -> card arguments: every cluster size S the plan picks, rank
    boundaries, L not a multiple of the chunk, L under a block's threads,
    chunks walked in tiles, empty rows, the lane-by-lane path (T=1, 3, 5)
    and an arena off 16-byte alignment."""
    import numpy as np
    import torch

    def case(b, seq_len, lens, **kw):
        return card_args(densify_case(rng, b, seq_len, lens, **kw), seq_len)

    ts = dict(ts0=3_000_000_000)
    boundary = [2048 - 256 * r for r in range(8)] + [1, 255, 256, 0]
    boundary += list(rng.integers(0, 4096, 32 - len(boundary)))
    over = [65, 200, 64, 1, 0, 130, 64, 500]
    misaligned = card_args(densify_case(rng, 32, 2048, rng.integers(
        0, 4096, 32), **ts), 2048)
    n = misaligned[0].shape[0]
    flat = torch.zeros(n * 4 + 1, dtype=torch.int32, device=DEVICE)
    shifted = flat[1:].view(n, 4)                 # 4 bytes past alignment
    shifted.copy_(misaligned[0])
    misaligned = (shifted, *misaligned[1:])
    return {
        "S=8: first valid position on each rank boundary, rows only in the "
        "last rank": case(32, 2048, boundary, **ts),
        "S=4 (L=1024)": case(32, 1024, rng.integers(0, 2048, 32), **ts),
        "S=2 (L=512)": case(32, 512, rng.integers(0, 1024, 32), **ts),
        "L=2049, not a multiple of the chunk": case(32, 2049, boundary, **ts),
        "L=20, under a block's threads": case(
            6, 20, [21, 0, 20, 5, 1, 19], **ts),
        "tiles over 8 ranks (B=1, L=20000)": case(1, 20000, [19_223], **ts),
        "tiles in one block (B=200, L=5000)": case(
            200, 5000, rng.integers(0, 10_000, 200), **ts),
        "over-length rows": case(8, 64, over),
        "all-empty rows": case(6, 64, [0] * 6, **ts),
        "T=5 with a float32 lane": case(5, 16, [3, 16, 0, 7, 9],
                                        float_lane=True, **ts),
        "T=1 timestamp lane": case(7, 300, [300, 1, 0, 299, 12, 300, 77],
                                   traits=(), ts0=2**31 + 12_345),
        "T=1 drift trait": case(6, 32, [31, 0, 32, 5, 2, 9],
                                traits=("category",)),
        "T=3": case(9, 2048, rng.integers(0, 4096, 9),
                    traits=("item_id", "category"), **ts),
        "arena one int32 off 16-byte alignment": misaligned,
    }


def densify_phase():
    import numpy as np
    import torch

    from repro_torch.kernels.fused import ops

    L, b = 2048, BATCH
    shapes = densify_shapes()
    main_case = shapes[f"B={b}"][0]
    err = 0
    for case, _ in shapes.values():
        for ts in (True, False):
            err = max(err, kernel_vs_plain(card_args(case, L, ts)))
    edge = densify_edge_cases(np.random.default_rng(SEED + 4))
    empty = card_args(densify_case(np.random.default_rng(SEED), 0, 64, []),
                      64)
    before = ops.fused_densify.launches
    require(ops.fused_densify(*empty)[0].shape == (0, 64, 3)
            and ops.fused_densify.launches == before,
            "an empty batch launched")
    plans = {}
    for name, args in edge.items():
        err = max(err, kernel_vs_plain(args))
        dense = ops.fused_densify(*args)[0]
        p = ops.launch_plan(args[0], args[1].shape[0] - 1, args[2], dense)
        plans[name] = f"S={p['cluster']} K={p['positions']} " + (
            "vec" if p["vec"] else "lanes")
    say("kernel", f"fused_densify == plain version, twice to identical "
                  f"bytes, at B={b} and B=1024 (L={L}, T=4, timestamps on "
                  f"and off) and on {len(edge)} edge cases: "
                  + "; ".join(f"{k} ({v})" for k, v in plans.items())
                  + f"; an empty batch launches nothing; max_abs_err {err}")

    args = card_args(main_case, L)
    for ts, a in (("on", args), ("off", card_args(main_case, L, ts=False))):
        kernels_a_call(lambda: ops.fused_densify(*a),
                       "fused_densify_kernel",
                       f"fused_densify B={b} L={L} T=4, timestamps {ts}")
    times = densify_timings(shapes)
    plan = {}
    for name, (case, _) in shapes.items():
        a = card_args(case, L)
        p = ops.launch_plan(a[0], a[1].shape[0] - 1, L,
                            ops.fused_densify(*a)[0])
        plan[name] = p
        say("kernel", f"fused_densify plan at {name} L={L} T=4: clusters "
                      f"of {p['cluster']} blocks a row, {p['positions']} "
                      f"positions a thread, {p['threads']} threads a block, "
                      f"{p['chunk']} positions a block, "
                      f"{'16-byte words' if p['vec'] else 'lane by lane'}")
    plain_ms = cuda_ms(lambda: ops.fused_densify_ref(*args), iters=50)
    plain_dev_ms = device_ms(lambda: ops.fused_densify_ref(*args), iters=50)
    say("kernel", f"fused_densify plain version at B={b}: {plain_ms:.6f} ms "
                  f"a call (device only {plain_dev_ms:.6f} ms); library_ms: "
                  f"null (no single PyTorch call computes this function)")

    dense, stamps = ops.fused_densify(*args)
    arena, offs, _, bases, ts_col = args
    t = arena.shape[1]
    c_args = (arena.data_ptr(), offs.data_ptr(), bases.data_ptr(),
              dense.data_ptr(), stamps.data_ptr(), b, L, t, ts_col,
              torch.cuda.current_stream(arena.device).cuda_stream)
    host = host_split(f"fused_densify B={b} L={L} T=4 (timestamps on)",
                      lambda: ops.fused_densify(*args),
                      ops.LIBRARY.function("fused_densify_launch"), c_args,
                      None, "", lambda: (arena.new_empty((b, L, t)),
                                         arena.new_empty((b, L),
                                                         dtype=torch.int64)),
                      arena)
    main, big = times[f"B={b}"], times["B=1024"]
    return {"name": "fused_densify", "route": "cuda",
            "source": "src/repro_torch/kernels/fused/csrc/fused_densify.cu",
            "replaces": "src/repro/kernels/fused/fused.py:59",
            "max_abs_err": err, "ms": main["ms"],
            "device_ms": main["device_ms"], "plain_ms": plain_ms,
            "plain_device_ms": plain_dev_ms, "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "library_device_ms": None,
            "more": {"cluster": plan[f"B={b}"]["cluster"],
                     "ts_off_device_ms": main["ts_off_device_ms"],
                     "wrapper_us": host["wrapper_us"], "c_us": host["c_us"],
                     "b1024_ms": big["ms"],
                     "b1024_device_ms": big["device_ms"],
                     "b1024_bound_ms": big["bound_ms"],
                     "b1024_cluster": plan["B=1024"]["cluster"]}}


# ---------------------------------------------------------------------------
# phase 0a: the multi-tensor AdamW kernel over the benchmark cells' leaves
# ---------------------------------------------------------------------------

ADAMW_MODELS = ("dlrm_uih", "dcn_v2")   # FULL configs whose leaves it updates
ADAMW_ITERS = 20           # calls a timing window (a DLRM-UIH call ~15 ms)
ADAMW_CHECK_STEPS = 2      # steps held against the plain version
# kernel against plain version, float32 both: float64 norm partials against
# a float32 reduction, one rounded scale against two, contracted
# multiply-adds (tests/test_torch_gpu.py's AW_TOL). The limits scale with
# the arrays: with the clip active over ~1.5e9 parameters the scaled
# gradient is ~2.5e-5, m ~5e-6 and v ~3e-11, where any fixed atol would
# pass anything. Each element of p, m and v: within ADAMW_RTOL of |want|
# plus ADAMW_ATOL_SHARE of the array's largest |want|. Each parameter
# leaf's error norm within ADAMW_CHANGE_RTOL of its change's norm over the
# steps (rounding reads ~1e-6 there; a dropped decay reads
# ADAMW_CHECK_DECAY times the leaf's rms, 1e-3 for a table drawn at 0.01)
ADAMW_RTOL, ADAMW_ATOL_SHARE, ADAMW_CHANGE_RTOL = 2e-5, 1e-6, 2e-5
ADAMW_CHECK_DECAY = 0.1    # ten times the configs' 0.01: a visible decay
ADAMW_GRAD_STD = 1e-3      # the drawn gradients' scale: the clip is active


def adamw_leaves(name: str):
    """FULL ``name``'s parameter leaves on the card, gradients drawn there,
    zero moments and the ``ndim >= 2`` decays of ``adamw_update``."""
    import torch

    from repro_torch.configs import dcn_v2, dlrm_uih
    from repro_torch.models import recsys as R
    from repro_torch.tree import tree_leaves

    init, cfg = {"dlrm_uih": (R.init_dlrm_uih, dlrm_uih.FULL),
                 "dcn_v2": (R.init_dcn_v2, dcn_v2.FULL)}[name]
    params = [p.detach() for p in tree_leaves(init(cfg, SEED, DEVICE))]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    grads = [torch.randn(p.shape, generator=gen, device=DEVICE)
             .mul_(ADAMW_GRAD_STD) for p in params]
    ms = [torch.zeros_like(p) for p in params]
    vs = [torch.zeros_like(p) for p in params]
    return params, grads, ms, vs, [ADAMW_CHECK_DECAY * (p.ndim >= 2)
                                   for p in params]


def adamw_step_kwargs(step: int) -> dict:
    import numpy as np

    f = np.float32
    return dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, clip=1.0,
                bc1=float(f(1) - f(0.9) ** f(step)),
                bc2=float(f(1) - f(0.95) ** f(step)))


def adamw_err(got, want, p0=None) -> tuple:
    """Over a leaf, in blocks of 2^26 elements (no leaf-sized temporary):
    max |got - want|, max of it over ADAMW_RTOL |want| + ADAMW_ATOL_SHARE
    max |want|, and for a parameter (``p0`` its value before the steps)
    ||got - want|| over ||want - p0|| (else 0)."""
    def blocks(t):
        return t.reshape(-1).split(1 << 26)

    atol = ADAMW_ATOL_SHARE * max(float(b.abs().max()) for b in blocks(want))
    worst, ratio, off, change = 0.0, 0.0, 0.0, 0.0
    for i, (a, b) in enumerate(zip(blocks(got), blocks(want))):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        ratio = max(ratio, float((d / (atol + ADAMW_RTOL * b.abs())).max()))
        if p0 is not None:
            off += float(d.double().square().sum())
            change += float((b - blocks(p0)[i]).double().square().sum())
    return worst, ratio, (off / change) ** 0.5 if p0 is not None else 0.0


def adamw_model(name: str, smi: str) -> dict:
    import torch

    from repro_torch.kernels.adamw import ops as aw

    params, grads, ms, vs, decay = adamw_leaves(name)
    n = sum(p.numel() for p in params)
    table = aw.LeafTable()
    before = (aw.adamw.launches, aw.adamw.leaves, aw.adamw.elements,
              aw.adamw.staged, aw.adamw.uploads)
    p0 = [p.clone() for p in params]
    twin = [[t.clone() for t in ts] for ts in (params, ms, vs)]
    for step in range(1, ADAMW_CHECK_STEPS + 1):
        kw = adamw_step_kwargs(step)
        got = aw.adamw(params, grads, ms, vs, decay, **kw, grad_scale=0.5,
                       table=table)
        want = aw.adamw_ref(twin[0], [g.clone() for g in grads], twin[1],
                            twin[2], decay, **kw, grad_scale=0.5)
        torch.cuda.synchronize()
        norm_err = abs(float(got) - float(want)) / float(want)
        require(norm_err <= 2e-6, f"adamw {name}: norm {float(got)} against "
                                  f"the plain version's {float(want)}")
    errs = {}
    for kind, gots, wants in zip("pmv", (params, ms, vs), twin):
        for i, (a, b) in enumerate(zip(gots, wants)):
            errs[kind, i] = adamw_err(a, b, p0[i] if kind == "p" else None)
    worst = max(e[0] for e in errs.values())
    ratios = {k: max(e[1] for (kk, _), e in errs.items() if kk == k)
              for k in "pmv"}
    leaf, change = max(((i, e[2]) for (k, i), e in errs.items() if k == "p"),
                       key=lambda x: x[1])
    check = (f"max abs err {worst:.3e}; worst element over its limit p "
             f"{ratios['p']:.3e}, m {ratios['m']:.3e}, v {ratios['v']:.3e}; "
             f"worst leaf's error over its change {change:.3e} (leaf {leaf}, "
             f"{tuple(params[leaf].shape)})")
    require(max(ratios.values()) <= 1.0 and change <= ADAMW_CHANGE_RTOL,
            f"adamw {name}: off the plain version after {ADAMW_CHECK_STEPS} "
            f"steps: {check} (limits 1 and {ADAMW_CHANGE_RTOL}; rtol "
            f"{ADAMW_RTOL}, atol {ADAMW_ATOL_SHARE} of each array's largest)")
    del twin, p0, got, want
    kw = adamw_step_kwargs(3)

    def kernel():
        aw.adamw(params, grads, ms, vs, decay, **kw, grad_scale=0.5,
                 table=table)

    def plain():
        aw.adamw_ref(params, grads, ms, vs, decay, **kw, grad_scale=0.5)

    out = {"elements": n, "leaves": len(params), "max_abs_err": worst,
           "change_err": change, "element_err": ratios,
           "bound_ms": 32 * n / HBM_BYTES_PER_S * 1e3}
    out["device_ms"] = device_ms(kernel, ADAMW_ITERS)
    out["ms"] = cuda_ms(kernel, ADAMW_ITERS, warmup=3)
    after = (aw.adamw.launches, aw.adamw.leaves, aw.adamw.elements,
             aw.adamw.staged, aw.adamw.uploads)
    counts = dict(zip(("launches", "leaves", "elements", "staged", "uploads"),
                      (a - b for a, b in zip(after, before))))
    out["plain_device_ms"] = device_ms(plain, ADAMW_ITERS)
    out["plain_ms"] = cuda_ms(plain, ADAMW_ITERS, warmup=3)
    torch.cuda.reset_peak_memory_stats()
    for p, g in zip(params, grads):
        p.grad = g
    lib = torch.optim.AdamW(params, lr=kw["lr"], betas=(0.9, 0.95),
                            eps=kw["eps"], weight_decay=0.01, fused=True)
    out["library_device_ms"] = device_ms(lib.step, ADAMW_ITERS)
    out["library_ms"] = cuda_ms(lib.step, ADAMW_ITERS, warmup=3)
    for p in params:
        p.grad = None
    del lib
    say("adamw", f"{name}: {len(params)} leaves, {n} float32 parameters; "
                 f"{ADAMW_CHECK_STEPS} steps against the plain version: "
                 f"{check}; kernel {out['device_ms']:.6f} ms "
                 f"device only, {out['ms']:.6f} ms a call; bound "
                 f"{out['bound_ms']:.6f} ms (32 B a parameter at "
                 f"{HBM_BYTES_PER_S:.3g} B/s, "
                 f"{100 * out['bound_ms'] / out['device_ms']:.1f}%); plain "
                 f"{out['plain_device_ms']:.6f} / {out['plain_ms']:.6f} ms; "
                 f"library (torch.optim.AdamW fused, no clip) "
                 f"{out['library_device_ms']:.6f} / {out['library_ms']:.6f} "
                 f"ms; counters over the check and the kernel's windows "
                 f"{counts} ({smi})")
    require(counts["launches"] >= 2 * ADAMW_CHECK_STEPS
            and counts["launches"] % 2 == 0 and not counts["staged"]
            and counts["uploads"] == 1,
            f"adamw {name}: counters {counts}: want two launches a call, no "
            f"staged leaf and the leaf table copied once")
    out["counters"] = counts
    return out


def adamw_phase(smi: str) -> dict:
    """The AdamW kernel's entry of the kernels' table: DLRM-UIH's numbers,
    DCN-v2's under ``more``; ``launches`` is the main path's, set there."""
    from repro_torch.kernels.adamw import ops as aw

    models = {}
    for name in ADAMW_MODELS:
        models[name] = adamw_model(name, smi)
        release(f"adamw {name}")
    main = models[ADAMW_MODELS[0]]
    return {"name": "adamw", "route": "CUDA C++",
            "source": "src/repro_torch/kernels/adamw/csrc/adamw.cu",
            "replaces": "none: the reference's AdamW is jnp code that XLA "
                        "fuses",
            "launches": None, "bound_by": "memory",
            **{k: main[k] for k in ("max_abs_err", "ms", "device_ms",
                                    "plain_ms", "plain_device_ms", "bound_ms",
                                    "library_ms", "library_device_ms")},
            "more": {"models": models,
                     "standalone_launches": aw.adamw.launches}}


# The grouped expert product at the DeepSeek-V2-Lite cell's shapes: a
# microbatch of 8 x 2048 tokens at top-6 gives the path 98,304 rows, of which
# the card's 8 held experts get 1,536 each on average (12,288); w_in's
# (2048, 2 x 1408) and w_out's (1408, 2048), each form.
GG_ROWS = 8 * 2048 * 6
GG_LOAD = 1536
GG_EXPERTS = 8
# uneven loads for the check: groups that end inside a 128-row tile, an empty
# group and a group of one row, ~1,520 rows an expert as on the cell's path
GG_UNEVEN = (1536, 0, 1700, 1, 2900, 1871, 2047, 2129)
# the cell's dropless MoE layer: (batch, length, d) and its MoEConfig
DL_SHAPE = (8, 2048, 2048)
DL_MOE = dict(n_experts=64, top_k=6, d_ff=1408, n_shared=2,
              capacity_factor=None, n_held=8, norm_topk_prob=False,
              aux_alpha=0.001)
GG_SHAPES = (("w_in", 2048, 2816), ("w_out", 1408, 2048))
GG_ITERS = 20
GG_RTOL = 1e-2             # bf16 results of float32 sums: ~2^-8 a value


def grouped_library(args, off, mode):
    """``torch._grouped_mm`` computing the same form (the yardstick; the
    port never calls it), or None where this torch has none for it."""
    import torch

    from repro_torch.kernels.grouped_gemm import ops as gg

    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    ends = off[1:].to(torch.int32)
    a, b = args
    if mode == gg.FWD:
        pair = (a, b.transpose(-2, -1).contiguous().transpose(-2, -1))
    elif mode == gg.DX:
        pair = (a, b.transpose(-2, -1))
    else:
        pair = (a.T.contiguous(), b)       # (K, R), the rows grouped
    call = (lambda: fn(pair[0], pair[1], offs=ends))
    try:
        call()
    except (RuntimeError, TypeError, ValueError) as e:
        say("grouped_gemm", f"torch._grouped_mm refuses form {mode}: "
                            f"{str(e).splitlines()[0][:160]}")
        return None
    return call


def grouped_gemm_forms(name: str, k: int, n: int, gen, off, smi: str
                      ) -> dict:
    """Each form of the grouped product over one weight's shape: checked
    against the plain version in float32, timed beside its bound, the plain
    version and ``torch._grouped_mm``."""
    import torch

    from repro_torch.kernels.grouped_gemm import ops as gg

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).bfloat16()

    rows = int(off[-1])
    uneven = torch.tensor((0,) + GG_UNEVEN, device=DEVICE).cumsum(0)
    a, w, dy = draw(GG_ROWS, k), draw(GG_EXPERTS, k, n), draw(GG_ROWS, n)
    forms = {}
    for form, mode, args in (("fwd", gg.FWD, (a, w)), ("dx", gg.DX, (dy, w)),
                             ("dw", gg.DW, (a, dy))):
        err = 0.0
        for at in (off, uneven):
            got = gg.grouped_gemm(*args, at, mode).float()
            want = gg.grouped_gemm_ref(*(x.float() for x in args), at, mode)
            err = max(err, float(((got - want).abs()
                                  / (want.abs() + 1.0)).max()))
            require(mode == gg.DW or not got[int(at[-1]):].any(),
                    f"grouped_gemm {name} {form}: rows past the groups not 0")
            del got, want
        require(err <= GG_RTOL, f"grouped_gemm {name} {form}: {err:.3e} off "
                                f"the plain version (even and uneven loads)")

        def kernel(args=args, mode=mode):
            gg.grouped_gemm(*args, off, mode)

        def plain(args=args, mode=mode):
            gg.grouped_gemm_ref(*args, off, mode)

        r = {"max_rel_err": err,
             "bound_ms": 2 * rows * k * n / BF16_PEAK_FLOPS * 1e3,
             "device_ms": device_ms(kernel, GG_ITERS, "grouped_gemm_kernel"),
             "ms": cuda_ms(kernel, GG_ITERS, warmup=3),
             "plain_device_ms": device_ms(plain, GG_ITERS),
             "plain_ms": cuda_ms(plain, GG_ITERS, warmup=3)}
        lib = grouped_library(args, off, mode)
        r["library_device_ms"] = device_ms(lib, GG_ITERS) if lib else None
        r["library_ms"] = cuda_ms(lib, GG_ITERS, warmup=3) if lib else None
        forms[f"{name}.{form}"] = r
        say("grouped_gemm",
            f"{name} {form} ({rows} of {GG_ROWS} rows, K {k}, N {n}): err "
            f"{err:.2e}; kernel {r['device_ms']:.6f} ms device, "
            f"{r['ms']:.6f} a call; bound {r['bound_ms']:.6f} "
            f"({100 * r['bound_ms'] / r['device_ms']:.1f}%); plain "
            f"{r['plain_device_ms']:.6f} / {r['plain_ms']:.6f}; "
            f"torch._grouped_mm {r['library_device_ms']} / {r['library_ms']} "
            f"({smi})")
    return forms


def grouped_gemm_phase(smi: str) -> dict:
    """The grouped product's entry of the kernels' table (``w_in``'s forward
    form; every form under ``more``)."""
    import torch

    from repro_torch.kernels.grouped_gemm import ops as gg

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    off = torch.arange(GG_EXPERTS + 1, device=DEVICE,
                       dtype=torch.int64) * GG_LOAD
    before = gg.grouped_gemm.launches
    forms = {}
    for name, k, n in GG_SHAPES:
        forms.update(grouped_gemm_forms(name, k, n, gen, off, smi))
        release(f"grouped_gemm {name}")
    main = forms["w_in.fwd"]
    return {"name": "grouped_gemm", "route": "CUDA C++",
            "source": "src/repro_torch/kernels/grouped_gemm/csrc/"
                      "grouped_gemm.cu",
            "replaces": "none: the reference's MoE runs a batched product "
                        "over a fixed capacity",
            "launches": None, "bound_by": "tensor cores",
            "max_abs_err": main["max_rel_err"],
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "plain_device_ms", "bound_ms",
                                    "library_ms", "library_device_ms")},
            "more": {"forms": forms,
                     "standalone_launches": gg.grouped_gemm.launches
                     - before}}


class PlainGroupedMM:
    """``grouped_mm`` with every form run by ``grouped_gemm_ref`` (the
    plain version), the same autograd as the kernel's; each call's offsets
    kept in ``offsets``."""

    def __init__(self):
        import torch

        from repro_torch.kernels.grouped_gemm import ops as gg

        self.offsets = []

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a, w, off):
                ctx.save_for_backward(a, w, off)
                return gg.grouped_gemm_ref(a, w, off, gg.FWD)

            @staticmethod
            def backward(ctx, dy):
                a, w, off = ctx.saved_tensors
                return (gg.grouped_gemm_ref(dy, w, off, gg.DX),
                        gg.grouped_gemm_ref(a, dy, off, gg.DW), None)

        self.fn = Fn

    def __call__(self, a, w, offsets):
        self.offsets.append(offsets)
        return self.fn.apply(a, w, offsets)


def dropless_phase(smi: str) -> int:
    """One full-width dropless MoE layer of the DeepSeek-V2-Lite cell on
    the card, forward and backward through ``moe.moe_dropless`` (the path
    the grouped kernel serves): 8 x 2048 tokens of d 2048, the real router
    over 64 experts, top-6, 8 held, 2 shared. Requires the kernel's 6
    launches (2 forward, DX and DW of each weight), the layer's counters
    (every token, no pair dropped) and the operations counted, and holds
    the output and the gradients of x, ``w_in`` and ``w_out`` against the
    same layer run through the plain version on the same offsets. Returns
    the launches."""
    import torch

    from repro_torch.kernels.grouped_gemm import ops as gg
    from repro_torch.models import moe as M

    cfg = M.MoEConfig(**DL_MOE)
    b, n, d = DL_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = M.init_moe(gen, d, cfg, device=DEVICE)
    x0 = torch.randn(DL_SHAPE, generator=gen, device=DEVICE).bfloat16()
    names = ("x", "w_in", "w_out")

    def layer():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        x = x0.clone().requires_grad_()
        out, aux = M.moe_dropless(p, x, cfg)
        (out.float().square().mean() + aux).backward()
        return out.detach(), dict(zip(names, (x.grad, p["w_in"].grad,
                                              p["w_out"].grad)))

    kernel_mm, plain_mm = M.grouped_mm, PlainGroupedMM()
    seen = []

    def counted_mm(a, w, offsets):
        seen.append(offsets)
        return kernel_mm(a, w, offsets)

    torch.cuda.synchronize()
    gg.grouped_gemm.launches = 0              # count this path only
    M.STATS.reset()
    f0 = gg.flops()
    M.grouped_mm = counted_mm
    try:
        out, grads = layer()
        torch.cuda.synchronize()
        launches, counts = gg.grouped_gemm.launches, M.STATS.read()
        flops = gg.flops() - f0
        M.grouped_mm = plain_mm
        want_out, want = layer()
    finally:
        M.grouped_mm = kernel_mm
    pairs = counts["pairs_held"]
    require(launches == 6, f"dropless layer: {launches} grouped_gemm "
                           f"launches, want 6")
    require(counts["tokens"] == b * n and counts["dropped"] == 0
            and 0 < pairs <= b * n * cfg.top_k,
            f"dropless layer: counters {counts}")
    require(flops == 3 * 2 * pairs * (d * 2 * cfg.d_ff + cfg.d_ff * d),
            f"dropless layer: {flops} operations counted for {pairs} pairs")
    require(len(seen) == len(plain_mm.offsets) == 2
            and all(torch.equal(a, b) for a, b in zip(seen, plain_mm.offsets)),
            "dropless layer: the plain run routed to other offsets")
    loads = (seen[0][1:] - seen[0][:-1]).tolist()
    errs = {"out": float((out.float() - want_out.float()).norm()
                         / want_out.float().norm())}
    for k in names:
        errs[k] = float((grads[k].float() - want[k].float()).norm()
                        / want[k].float().norm())
    require(max(errs.values()) <= GG_RTOL,
            f"dropless layer off the plain version: {errs} (limit {GG_RTOL}, "
            f"bf16 results of float32 sums)")
    say("dropless", f"{b} x {n} tokens of d {d}, {cfg}: "
                    f"{launches} grouped_gemm launches; counters {counts}; "
                    f"loads {loads}; {flops} operations counted; norm errors "
                    f"against the plain version on the same offsets {errs} "
                    f"({smi})")
    return launches


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


def check_device_feed(phase: str, rec, launches: int, cs, seq_len: int
                      ) -> int:
    """What a training feed that densifies on the card must show, for the
    payloads ``rec`` recorded: ``fused_densify`` launched as often as they
    call for (``launches`` counted over the run) and more than never, the
    first device batch byte for byte ``densify_host`` of its payload, and
    fewer H2D bytes than the dense batches hold. Returns the dense bytes."""
    import numpy as np

    from repro_torch.dpp.device_mat import densify_host

    expected = sum(launches_called_for(p) for p in rec.payloads)
    groups = launches / max(len(rec.payloads), 1)
    require(launches > 0 and launches == expected,
            f"{phase}: fused_densify launches {launches} != the {expected} "
            f"the {len(rec.payloads)} transferred payloads call for")
    say(phase, f"fused_densify launched {launches} times for "
               f"{len(rec.payloads)} transferred batches ({groups:g} groups "
               f"each), {cs.full_batches} delivered to the trainer")
    payload, dev = rec.payloads[0], rec.first
    host = densify_host(payload)
    require(list(dev) == list(host),
            f"{phase}: first batch keys differ from densify_host")
    for k, want in host.items():
        got = dev[k].cpu().numpy()
        require(got.dtype == want.dtype and got.shape == want.shape
                and got.tobytes() == want.tobytes(),
                f"{phase}: first batch {k!r} differs from densify_host")
    lens = np.concatenate([np.asarray(p["uih_len"]) for p in rec.payloads])
    fill = float(np.asarray(payload["uih_len"]).clip(max=seq_len).mean()
                 / seq_len)
    fill_all = float(lens.clip(max=seq_len).mean() / seq_len)
    stamps = (f", uih_timestamp max {int(host['uih_timestamp'].max())}"
              if "uih_timestamp" in host else "")
    say(phase, f"first batch == densify_host of its payload, byte for byte "
               f"({len(host)} keys, fill {fill:.3f}{stamps}); mean fill of "
               f"all transferred batches {fill_all:.3f}")
    dense_bytes = sum(v.nbytes for p in rec.payloads
                      for v in densify_host(p).values())
    require(0 < cs.h2d_bytes < dense_bytes,
            f"{phase}: h2d_bytes {cs.h2d_bytes} not below dense "
            f"{dense_bytes}")
    return dense_bytes


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


ROW_KEY = ("user_id", "request_ts", "cand_item_id")   # one example's row


def dlrm_loss(cfg, seen, keys=None):
    """The trainers' loss: DLRM-UIH on the device batch, with the model prep
    (``dlrm_uih_prep``) run there too. It counts the microbatches and their
    tensors off the card in ``seen``; with a ``keys`` list it also keeps each
    microbatch's (user_id, request_ts, cand_item_id) rows on the card, to be
    read once training is over."""
    import torch

    from repro_torch.models import recsys as R

    def loss_fn(p, batch):
        seen["microbatches"] += 1
        seen["off_card"] += sum(v.device.type != DEVICE
                                for v in batch.values())
        if keys is not None:
            keys.append(torch.stack([batch[k].long() for k in ROW_KEY]))
        return R.dlrm_uih_loss(p, R.dlrm_uih_prep(batch, cfg), cfg)

    return loss_fn


def main_path_phase(sim):
    import torch

    from repro_torch.configs.dlrm_uih import FULL
    from repro_torch.data import open_feed
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.adamw import ops as aw
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
    loss_fn = dlrm_loss(FULL, seen)
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
    aw.adamw.launches = aw.adamw.staged = aw.adamw.uploads = 0
    t0 = time.perf_counter()
    try:
        with trace:
            trainer.prof = trace
            trainer.fit(feed, max_steps=STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.fused_densify.launches
        adamw = (aw.adamw.launches, aw.adamw.staged, aw.adamw.uploads)
    finally:
        feed.close(timeout=30.0)
    peak = torch.cuda.max_memory_allocated()
    cs = feed.client_stats

    losses = [h["loss"] for h in trainer.history]
    require(trainer.step == STEPS, f"trained {trainer.step} of {STEPS} steps")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(seen["off_card"] == 0 and seen["microbatches"] == 2 * STEPS,
            f"batch tensors off the card: {seen}")
    dense_bytes = check_device_feed("main", rec, launches, cs, L_MAIN)
    # the kernel, two launches a step over every leaf, none staged; the
    # trainer's leaf table is copied again only when a gradient moved
    require(adamw[0] == 2 * STEPS and adamw[1] == 0
            and 1 <= adamw[2] <= STEPS,
            f"main: AdamW launches, staged leaves and table copies {adamw}; "
            f"want {2 * STEPS}, 0 and 1 to {STEPS}")
    say("main", f"AdamW kernel: {adamw[0]} launches over {STEPS} steps, "
                f"{adamw[1]} staged leaves, leaf table copied {adamw[2]} "
                f"times")
    say("main", f"{STEPS} AdamW steps (grad_accum 2, batch {BATCH}) in "
                f"{wall:.3f} s = {STEPS / wall:.3f} steps/s; losses "
                f"{losses[0]:.5f} -> {losses[-1]:.5f}, all finite; peak "
                f"memory {peak} B; h2d {cs.h2d_bytes} B vs dense "
                f"{dense_bytes} B; starved {cs.starved_time_s:.6f} s "
                f"(host {cs.starved_host_s:.6f} s, h2d "
                f"{cs.starved_h2d_s:.6f} s), h2d time {cs.h2d_time_s:.6f} s")
    step_profile(trainer, trace)
    return launches, adamw[0]


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
# phase 4c: the other ranking tenants — FULL DCN-v2, DIEN and BERT4Rec, each
# trained from its own device-materialized feed at its own length, served,
# and scoring 1,000,000 candidates; FULL DLRM-UIH scoring too
# ---------------------------------------------------------------------------

TENANT_STEPS = 10
SERVE_ROWS = 512           # RECSYS_SHAPES["serve_p99"]: a serving batch
N_CANDIDATES = 1_000_000   # RECSYS_SHAPES["retrieval_cand"]: one user's
SCORE_CHECKS = 16          # sampled candidates held against *_forward
# |score - forward| <= RTOL * |forward| + ATOL * max |forward| over the
# sampled candidates: 2 and 1 bf16 epsilons (2^-7). The batched tail and
# the forward pass run the same bf16 ops on GEMMs of other shapes, so they
# differ by rounding alone.
SCORE_RTOL = 2 * 2**-7
SCORE_ATOL = 2**-7


def tenant_table():
    """Each tenant's FULL config, feed length and traits, and model
    functions. DCN-v2 takes DIEN's feed: its prep reads only the scalars
    and the history's length."""
    import torch

    from repro_torch.configs import bert4rec, dcn_v2, dien
    from repro_torch.models import recsys as R

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)  # BERT4Rec's draws
    both = ("item_id", "category")
    return {
        "dcn-v2": dict(cfg=dcn_v2.FULL, seq_len=dien.FULL.seq_len,
                       traits=both, init=R.init_dcn_v2, prep=R.dcn_v2_prep,
                       loss=R.dcn_v2_loss, forward=R.dcn_v2_forward,
                       score=R.dcn_v2_score_candidates),
        "dien": dict(cfg=dien.FULL, seq_len=dien.FULL.seq_len, traits=both,
                     init=R.init_dien, prep=R.dien_prep, loss=R.dien_loss,
                     forward=R.dien_forward,
                     score=R.dien_score_candidates),
        "bert4rec": dict(cfg=bert4rec.FULL, seq_len=bert4rec.FULL.seq_len,
                         traits=("item_id",), init=R.init_bert4rec,
                         prep=lambda b, cfg: R.bert4rec_prep(b, cfg, gen),
                         loss=R.bert4rec_loss, forward=R.bert4rec_forward,
                         score=R.bert4rec_score_candidates),
    }


def tenant_spec(name: str, seq_len: int, traits):
    """The tenant's own projection and features over the main path's sim:
    ``traits`` (item ids, and categories from the side-info group) at
    ``seq_len``, the same traits as candidate fields, click labels."""
    from repro_torch.core.projection import TenantProjection
    from repro_torch.data import DatasetSpec, SimSource
    from repro_torch.dpp.featurize import FeatureSpec

    groups = {"core": ("item_id",)}
    if "category" in traits:
        groups["sideinfo"] = ("category",)
    return DatasetSpec(
        tenant=TenantProjection(name, seq_len=seq_len,
                                feature_groups=tuple(groups),
                                traits_per_group=groups),
        source=SimSource(min_rows=(TENANT_STEPS + 4) * BATCH),
        batch_size=BATCH, base_batch_size=8, prefetch_depth=2, n_workers=4,
        device_materialize=True,
        features=FeatureSpec(seq_len=seq_len, uih_traits=traits,
                             candidate_fields=traits,
                             label_fields=("click",)))


def windows_ms(fn, iters: int, windows: int) -> float:
    """The median of ``windows`` windows of ``cuda_ms(fn, iters)``."""
    import statistics

    return statistics.median(cuda_ms(fn, iters, warmup=1)
                             for _ in range(windows))


def payload_densify_args(payload):
    """``fused_densify``'s card arguments for a payload's shared-plan trait
    group, packed as ``DeviceMaterializer`` packs it (no timestamp lane)."""
    import numpy as np
    import torch

    from repro_torch.kernels.fused import ops

    lens = np.asarray(payload["uih_len"])
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    arena, _ = ops.pack_arena({
        k[len("_arena_"):]: np.asarray(v) for k, v in payload.items()
        if k.startswith("_arena_")
        and f"_offsets_{k[len('_arena_'):]}" not in payload})
    case = (arena, offs.astype(np.int32), None, -1)
    dev = torch.device(DEVICE)
    args = (torch.from_numpy(arena).to(dev),
            torch.from_numpy(case[1]).to(dev), int(payload["_seq_len"]),
            None, -1)
    return args, densify_bound_ms(case, lens, args[2])


def train_tenant(name: str, t: dict, sim):
    """``TENANT_STEPS`` AdamW steps of the FULL tenant from its own
    device-materialized feed, held to ``check_device_feed``. Returns the
    parameters, the recorded payloads and the launch count."""
    import numpy as np
    import torch

    from repro_torch.data import open_feed
    from repro_torch.kernels.fused import ops
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    cfg = t["cfg"]
    t0 = time.perf_counter()
    params = t["init"](cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say("tenants", f"{name}: FULL params on the card in "
                   f"{time.perf_counter() - t0:.3f} s: {n_params} float32 "
                   f"({cfg.compute_dtype}); feed L={t['seq_len']}, traits "
                   f"{t['traits']}")
    seen = {"microbatches": 0, "off_card": 0}

    def loss_fn(p, batch):
        seen["microbatches"] += 1
        seen["off_card"] += sum(v.device.type != DEVICE
                                for v in batch.values())
        return t["loss"](p, t["prep"](batch, cfg), cfg)

    trainer = Trainer(loss_fn, params, TrainerConfig(
        opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TENANT_STEPS),
        grad_accum=2, log_every=5))
    feed = open_feed(tenant_spec(name, t["seq_len"], t["traits"]), sim,
                     device=DEVICE)
    rec = recording_materializer(feed.prefetcher.materialize)
    feed.prefetcher.materialize = rec          # before the first get()
    torch.cuda.reset_peak_memory_stats()
    ops.fused_densify.launches = 0             # count this tenant's path only
    t0 = time.perf_counter()
    try:
        trainer.fit(feed, max_steps=TENANT_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        feed.close(timeout=30.0)
    launches = ops.fused_densify.launches      # transfers are over
    peak = torch.cuda.max_memory_allocated()
    cs = feed.client_stats
    losses = [h["loss"] for h in trainer.history]
    require(trainer.step == TENANT_STEPS,
            f"{name}: trained {trainer.step} of {TENANT_STEPS} steps")
    require(all(math.isfinite(x) for x in losses), f"{name}: losses {losses}")
    require(seen["off_card"] == 0
            and seen["microbatches"] == 2 * TENANT_STEPS,
            f"{name}: batch tensors off the card: {seen}")
    dense_bytes = check_device_feed("tenants", rec, launches, cs,
                                    t["seq_len"])
    if "cand_category" in rec.payloads[0]:
        cats = np.unique(np.concatenate([p["cand_category"]
                                         for p in rec.payloads]))
        say("tenants", f"{name}: cand_category values fed: {cats.tolist()} "
                       f"(0 is the featurizer's default: the sim sets a "
                       f"candidate's category only with a label_fn)")
    say("tenants", f"{name}: {TENANT_STEPS} AdamW steps (grad_accum 2, batch "
                   f"{BATCH}) in {wall:.3f} s = {TENANT_STEPS / wall:.3f} "
                   f"steps/s; losses {' '.join(f'{x:.5f}' for x in losses)}, "
                   f"all finite; peak memory {peak} B; h2d {cs.h2d_bytes} B "
                   f"vs dense {dense_bytes} B; starved "
                   f"{cs.starved_time_s:.6f} s (host {cs.starved_host_s:.6f} "
                   f"s, h2d {cs.starved_h2d_s:.6f} s), h2d time "
                   f"{cs.h2d_time_s:.6f} s")
    return params, rec.payloads, launches


def serve_rows(payloads):
    """``SERVE_ROWS`` feed rows on the card: the transferred payloads,
    densified (``densify_host``) and cycled to the serving batch."""
    import numpy as np
    import torch

    from repro_torch.dpp.device_mat import densify_host

    rows = [densify_host(p) for p in payloads]
    idx = np.arange(SERVE_ROWS) % sum(len(r["uih_len"]) for r in rows)
    return {k: torch.from_numpy(np.concatenate([r[k] for r in rows])[idx])
            .to(DEVICE) for k in rows[0]}


def serve_tenant(name: str, forward, params, batch, cfg) -> None:
    """``forward`` on a ``SERVE_ROWS``-row batch under inference mode:
    finite outputs, and its ms a call (median of 5 windows of 10 calls)."""
    import torch

    with torch.inference_mode():
        out = forward(params, batch, cfg)
        require(out.shape == (SERVE_ROWS,) and bool(torch.isfinite(out).all()),
                f"{name}: serving forward gave {out.shape}, finite "
                f"{bool(torch.isfinite(out).all())}")
        ms = windows_ms(lambda: forward(params, batch, cfg), 10, 5)
    say("tenants", f"{name}: forward of {SERVE_ROWS} rows {ms:.6f} ms a call "
                   f"(CUDA events, median of 5 windows of 10), finite")


def score_tenant(name: str, t: dict, params, user) -> None:
    """One user against ``N_CANDIDATES`` seeded candidate ids inside the
    vocab (DIEN's with seeded categories): the shape, finite scores, ms a
    call and peak memory; then ``SCORE_CHECKS`` sampled candidates' scores
    against ``*_forward`` of the user with each of them."""
    import torch

    cfg, forward = t["cfg"], t["forward"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    vocab = cfg.field_vocab if name == "dcn-v2" else cfg.item_vocab
    cands = torch.randint(0, vocab, (N_CANDIDATES,), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    extra = ()
    if name == "dien":
        extra = (torch.randint(0, cfg.cat_vocab, (N_CANDIDATES,),
                               generator=gen, device=DEVICE,
                               dtype=torch.int32),)

    def score():
        return t["score"](params, user, cands, *extra, cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        scores = score()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        want_shape = ((1, N_CANDIDATES) if name == "bert4rec"
                      else (N_CANDIDATES,))
        require(tuple(scores.shape) == want_shape
                and bool(torch.isfinite(scores).all()),
                f"{name}: scores {tuple(scores.shape)} (want {want_shape}), "
                f"finite {bool(torch.isfinite(scores).all())}")
        ms = windows_ms(score, 2, 3)
        pick = torch.randint(0, N_CANDIDATES, (SCORE_CHECKS,), generator=gen,
                             device=DEVICE)
        rows = {k: v.expand(SCORE_CHECKS, *v.shape[1:]).clone()
                for k, v in user.items()}
        if name == "dcn-v2":
            rows["sparse_ids"][:, 0] = cands[pick]
        else:
            rows["cand_item_id"] = cands[pick]
        if name == "dien":
            rows["cand_category"] = extra[0][pick]
        got = scores.reshape(-1)[pick].float()
        want = forward(params, rows, cfg).float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    spread = float(want.max() - want.min())
    ok = bool(((got - want).abs()
               <= SCORE_RTOL * want.abs() + SCORE_ATOL * scale).all())
    require(ok, f"{name}: {SCORE_CHECKS} sampled scores differ from "
                f"{name} forward: max abs {err} (scale {scale})")
    say("tenants", f"{name}: 1 user x {N_CANDIDATES} candidates -> "
                   f"{want_shape}, finite, {ms:.6f} ms a call (median of 3 "
                   f"windows of 2); peak memory {peak} B ({peak - base} B "
                   f"over the resident {base} B); {SCORE_CHECKS} sampled "
                   f"scores == forward of the user with each candidate, max "
                   f"abs diff {err:.3e} (tolerance {SCORE_RTOL:g}*|f| + "
                   f"{SCORE_ATOL:g}*{scale:.4f}; the 16 forwards spread "
                   f"{spread:.4f})")


def dlrm_score(jf) -> None:
    """A freshly initialized FULL DLRM-UIH scoring one L=2048 user of the
    main path's featurized batch ``jf`` against ``N_CANDIDATES``."""
    import dataclasses

    import torch

    from repro_torch.configs.dlrm_uih import FULL
    from repro_torch.models import recsys as R

    host = jf.to_padded()
    batch = R.dlrm_uih_prep({k: torch.from_numpy(v).to(DEVICE)
                             for k, v in host.items()}, FULL)
    user = {k: v[:1] for k, v in batch.items() if k != "label"}
    params = R.init_dlrm_uih(FULL, seed=SEED, device=DEVICE)
    t = {"cfg": FULL, "score": R.dlrm_uih_score_candidates,
         # remat changes no value; it only saves memory in a backward pass
         "forward": lambda p, b, cfg: R.dlrm_uih_forward(
             p, b, dataclasses.replace(cfg, remat=False))}
    fill = float(user["uih_mask"].float().mean())
    say("tenants", f"dlrm-uih: FULL params fresh on the card; user history "
                   f"L={FULL.seq_len}, fill {fill:.3f}; the pooling's "
                   f"logits are ({N_CANDIDATES}, {FULL.seq_len}) float32, "
                   f"not chunked")
    score_tenant("dlrm-uih", t, params, user)


def tenants_phase(sim, jf) -> dict:
    """Train, serve and score each FULL tenant over the main path's sim,
    then score FULL DLRM-UIH for a user of the featurized batch ``jf``.
    Returns, per tenant, its ``fused_densify`` launches on its path and the
    kernel's times at its (L, T)."""
    import torch

    from repro_torch.kernels.fused import ops

    out = {}
    for name, t in tenant_table().items():
        params, payloads, launches = train_tenant(name, t, sim)
        args, bound = payload_densify_args(payloads[0])
        kernel_vs_plain(args)
        shape = f"L={args[2]} T={args[0].shape[1]}"
        d = out[name] = {
            "shape": shape, "launches": launches,
            "ms": windows_ms(lambda: ops.fused_densify(*args), 200, 6),
            "device_ms": device_ms(lambda: ops.fused_densify(*args),
                                   name="fused_densify_kernel"),
            "bound_ms": bound}
        say("tenants", f"{name}: fused_densify at B={BATCH} {shape} == plain "
                       f"version; {d['ms']:.6f} ms a call, device only "
                       f"{d['device_ms']:.6f} ms, bound {bound:.6f} ms "
                       f"(bytes at 3.35 TB/s)")
        batch = t["prep"](serve_rows(payloads), t["cfg"])
        serve_tenant(name, t["forward"], params, batch, t["cfg"])
        user = {k: v[:1] for k, v in batch.items()
                if k not in ("label", "mask_pos", "neg_ids")}
        score_tenant(name, t, params, user)
        del params, batch, user
        gc.collect()
        torch.cuda.empty_cache()
    dlrm_score(jf)
    return out


# ---------------------------------------------------------------------------
# phase 4b: the streaming leg — FULL DLRM-UIH trained from a live stream
# across the backfill -> live flip, under injected faults
# ---------------------------------------------------------------------------

HISTORY_DAYS = 29          # sealed days: the L=2048 windows are near full
BACKFILL_DAYS = 1          # the last sealed days the trainer replays
LIVE_DAYS = 2              # produced while the trainer runs
STREAM_WALL_S = 300.0      # TrainerConfig.max_wall_s: a guard, never reached
# FaultPlan.seeded(SEED, ...) rates over the first FAULT_TICKS ticks of each
# scope: at SEED 0, compactions at scan ticks 3 and 11 (each a full-width
# compaction, about a second of host time), crashes at 5 and 28,
# disconnects at consume ticks 16, 21, 27 and 30
FAULT_RATES = {"compaction_during_scan": 0.02, "stream_disconnect": 0.1,
               "worker_crash": 0.11}
FAULT_TICKS = 32


def build_stream_sim():
    """``build_sim``'s traffic with generation pinning: ``HISTORY_DAYS``
    sealed days, the last ``BACKFILL_DAYS`` of them with inference-time
    references captured (the audit's ground truth); the live days are the
    caller's to run. Returns the sim and the count of examples before the
    backfill range."""
    from repro_torch.core import events as ev
    from repro_torch.core.simulation import ProductionSim, SimConfig

    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=32, n_items=100_000,
                               days=HISTORY_DAYS + LIVE_DAYS + 1,
                               events_per_user_day_mean=80, seed=SEED),
        stripe_len=256, lookback_ms=24 * ev.MS_PER_DAY, seed=SEED,
        pin_generations=True))
    sealed = HISTORY_DAYS - BACKFILL_DAYS
    sim.run_days(sealed, capture_reference=False)
    before = len(sim.examples)
    for day in range(sealed, HISTORY_DAYS):
        sim.run_day(day, capture_reference=True)
    return sim, before


def stream_spec():
    """``examples/train_streaming.py``'s spec at ``L_MAIN`` with
    ``feed_spec()``'s tenant and features: backfill over the sealed
    ``BACKFILL_DAYS``, then the live stream; every full window
    checksum-validated, scans pinned to the logged generation."""
    import dataclasses

    from repro_torch.data import StreamSource

    first_day = HISTORY_DAYS - BACKFILL_DAYS
    return dataclasses.replace(
        feed_spec(),
        source=StreamSource(backfill=True, micro_batch_examples=8,
                            micro_batch_delay_s=0.05,
                            backfill_start_hour=24 * first_day,
                            backfill_end_hour=24 * HISTORY_DAYS - 1),
        consistency="audit", generations="pinned", device_materialize=False)


class WindowLog:
    """The windows the feed's workers materialize, kept by request id while
    ``recording()`` is on (a retried item's windows replace its earlier
    ones), and handed back to ``audit_streaming`` as its materializer: the
    audit then holds the very windows the trainer was fed. After the run
    the logged generations are gone (their leases are released) and a
    newer one, whose lookback has moved, cannot reproduce them."""

    def __init__(self):
        self.windows = {}

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.core.materialize import Materializer

        plain = Materializer.materialize_batch
        windows = self.windows

        def materialize_batch(mat, examples, projection=None):
            out = plain(mat, examples, projection)
            windows.update((e.request_id, w) for e, w in zip(examples, out))
            return out

        Materializer.materialize_batch = materialize_batch
        try:
            yield self
        finally:
            Materializer.materialize_batch = plain

    def materialize_batch(self, examples, projection=None):
        return [self.windows[e.request_id] for e in examples]


def stream_phase(smi: str) -> None:
    """Train FULL DLRM-UIH with ``Trainer.fit`` from a ``StreamSource`` feed
    while a producer thread runs the live days (daily compaction publishes
    new generations under the readers), through a seeded ``FaultPlan``.
    Then hold the run to the protocol: every example of the range trained
    exactly once, the trained windows audit clean, no lease left, each fault
    healed, and ``fused_densify`` never launched (the stream densifies on
    the host, as the reference does)."""
    import threading

    import torch

    from repro_torch.configs.dlrm_uih import FULL
    from repro_torch.core.consistency import audit_streaming
    from repro_torch.data import open_feed
    from repro_torch.kernels.fused import ops
    from repro_torch.models import recsys as R
    from repro_torch.testing import FaultPlan, wrap_sim
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    t0 = time.perf_counter()
    sim, before = build_stream_sim()
    n_sealed = len(sim.examples)
    say("stream", f"sim built in {time.perf_counter() - t0:.3f} s: "
                  f"{n_sealed} sealed examples, {n_sealed - before} in the "
                  f"backfill range; immutable generation "
                  f"{sim.immutable.generation} ({smi})")
    plan = FaultPlan.seeded(
        SEED, FAULT_RATES, FAULT_TICKS,
        on_compact=lambda: sim.run_compaction(sim.compaction_watermark,
                                              evict=False))
    spec = stream_spec()

    t0 = time.perf_counter()
    params = R.init_dlrm_uih(FULL, seed=SEED, device=DEVICE)
    seen = {"microbatches": 0, "off_card": 0}
    keys = []
    trainer = Trainer(dlrm_loss(FULL, seen, keys), params, TrainerConfig(
        opt=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100),
        grad_accum=2, log_every=5, max_wall_s=STREAM_WALL_S))
    torch.cuda.synchronize()
    say("stream", f"FULL DLRM-UIH params and AdamW state on the card in "
                  f"{time.perf_counter() - t0:.3f} s ({smi})")

    failed = []

    def producer():
        try:
            for day in range(HISTORY_DAYS, HISTORY_DAYS + LIVE_DAYS):
                sim.run_day(day, capture_reference=True)
        except BaseException as e:    # re-raised by the phase below
            failed.append(e)
        finally:
            sim.stream.close()

    prod = threading.Thread(target=producer, daemon=True, name="producer")
    log = WindowLog()
    first = {}
    with log.recording():
        feed = open_feed(spec, wrap_sim(sim, plan), device=DEVICE)
        transfer = feed.prefetcher._transfer

        def recording_transfer(host_batch):
            out = transfer(host_batch)
            if not first:
                first.update(host=host_batch, dev=out)
            return out

        feed.prefetcher._transfer = recording_transfer  # before the first get
        ops.fused_densify.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prod.start()
        try:
            trainer.fit(feed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.fused_densify.launches
            drained = feed.drained
        finally:
            feed.close(timeout=60.0)
            prod.join(timeout=60.0)
            if failed:   # it closed the stream early: name it first
                raise RuntimeError("the live producer failed") from failed[0]
    peak = torch.cuda.max_memory_allocated()
    require(not prod.is_alive(), "the producer did not finish")
    require(drained and wall < STREAM_WALL_S,
            f"fit stopped before the stream drained ({wall:.3f} s)")

    # every batch on the card, and the first one byte-equal to its host batch
    losses = [h["loss"] for h in trainer.history]
    require(trainer.step > 0 and all(math.isfinite(x) for x in losses),
            f"losses {losses}")
    require(seen["off_card"] == 0 and seen["microbatches"] == 2 * trainer.step,
            f"batch tensors off the card: {seen}")
    host, dev = first["host"], first["dev"]
    require(list(dev) == list(host), "first device batch keys differ")
    for k, want in host.items():
        got = dev[k].cpu().numpy()
        require(got.dtype == want.dtype and got.shape == want.shape
                and got.tobytes() == want.tobytes(),
                f"first device batch {k!r} differs from its host batch")
    require(launches == 0, f"fused_densify launched {launches} times on the "
                           f"stream path, which densifies on the host")

    # exactly once across the flip: backfill + live == the range, and every
    # history copy on the stream skipped
    expected = sim.examples[before:]
    bf = feed.session.backfill_stats
    trained = [tuple(r) for r in torch.cat(keys, 1).t().cpu().tolist()]
    by_key = {(e.user_id, e.request_ts, e.candidate["item_id"]): e
              for e in expected}
    require(sorted(trained) == sorted(by_key) and len(by_key) == len(expected),
            f"trained {len(trained)} rows, not each of the {len(expected)} "
            f"examples once")
    require(bf.flipped and bf.warehouse_examples == n_sealed - before
            and bf.warehouse_examples + bf.stream_examples == len(expected)
            and bf.duplicates_skipped == n_sealed,
            f"backfill handoff {bf}")

    # O2O: the windows the workers materialized as the micro-batches
    # arrived, in trained order, against the inference-time references
    refs = dict(zip((e.request_id for e in expected), sim.references))
    require(len(refs) == len(sim.references) == len(expected),
            "references do not cover the trained range")
    rows = [by_key[k] for k in trained]
    t0 = time.perf_counter()
    report = audit_streaming(
        (rows[i:i + BATCH] for i in range(0, len(rows), BATCH)), refs, log,
        sim.schema, spec.tenant)
    require(report.clean and report.examples == len(expected),
            f"audit_streaming {report}")

    ls = sim.immutable.lease_stats
    require(ls.acquired == ls.released and sim.stream.pending_leases() == 0,
            f"leases {ls}, {sim.stream.pending_leases()} pending")
    st = feed.stats()
    fired = [f.kind for f in plan.fired]
    src = feed.session.source.stats
    require(all(k in fired for k in FAULT_RATES), f"faults fired {fired}")
    require(st.workers.worker_restarts >= 1
            and src.reconnects == fired.count("stream_disconnect"),
            f"{st.workers.worker_restarts} worker restarts, "
            f"{src.reconnects} reconnects for {fired}")
    say("stream", f"checks passed: {len(trained)} rows trained, each example "
                  f"of the range once; audit_streaming clean over "
                  f"{report.examples} windows ({report.o2o_mismatches} O2O "
                  f"mismatches, {report.leaked_events} leaked events) in "
                  f"{time.perf_counter() - t0:.3f} s; leases {ls.acquired} "
                  f"acquired == {ls.released} released, 0 pending; faults "
                  f"fired {dict((k, fired.count(k)) for k in FAULT_RATES)}, "
                  f"{st.workers.worker_restarts} worker restarts, "
                  f"{src.reconnects} reconnects; fused_densify launches 0; "
                  f"all {seen['microbatches']} microbatches on the card, the "
                  f"first batch byte-equal to its host batch")

    cs, fr = st.client, st.freshness
    dense = sum(v.nbytes for v in host.values())
    mats = [w.materializer for w in feed.session.pool._workers]
    say("stream", f"{trainer.step} AdamW steps (grad_accum 2, batch {BATCH}) "
                  f"in {wall:.3f} s = {trainer.step / wall:.3f} steps/s; "
                  f"losses {losses[0]:.5f} -> {losses[-1]:.5f}; peak memory "
                  f"{peak} B ({smi})")
    say("stream", f"flip: {bf.warehouse_examples} warehouse examples over "
                  f"{bf.hours_replayed} hours, then {bf.stream_examples} live; "
                  f"watermark {bf.watermark}; {bf.duplicates_skipped} stream "
                  f"copies of history skipped ({smi})")
    say("stream", f"freshness over {fr.samples} live rows: event->gradient "
                  f"mean {fr.mean_event_to_gradient_s:.6f} s, max "
                  f"{fr.event_to_gradient_s_max:.6f} s; peak stream lag "
                  f"{src.max_lag} examples ({smi})")
    say("stream", f"starved {cs.starved_time_s:.6f} s (host "
                  f"{cs.starved_host_s:.6f} s, h2d {cs.starved_h2d_s:.6f} s), "
                  f"h2d time {cs.h2d_time_s:.6f} s; h2d "
                  f"{cs.h2d_bytes / max(cs.full_batches, 1):.0f} B a batch "
                  f"over {cs.full_batches} batches vs {dense} B dense in the "
                  f"first batch ({smi})")
    say("stream", f"generations: live {sim.immutable.generation}, "
                  f"{ls.generations_retained} retained and "
                  f"{ls.generations_gc} GC'd for leases; "
                  f"{sum(m.stats.pinned_windows for m in mats)} pinned "
                  f"windows, {sum(m.stats.stale_reresolved for m in mats)} "
                  f"stale windows re-resolved (live workers) ({smi})")


# ---------------------------------------------------------------------------
# the entry phase (after the stream phase): the reference's entry points
# on the port
# ---------------------------------------------------------------------------

ENTRY_TIMEOUT_S = 300.0    # a guard on each example's process
ENTRY_FULL = ("--config", "full", "--steps", "20")   # < 50: no 18 GB checkpoint
ENTRY_STREAM = ("--history-days", "1", "--live-days", "1",
                "--max-wall-s", "60")
ENTRY_REQUESTS = 512
ENTRY_LINES = {            # lines an example must print (each a prefix)
    "serve_retrieval": ("no leaked leases: True",),
    "streaming_vs_batch": ("batch replay vs streaming: 0 feature "
                           "mismatches",),
    "quickstart": ("  O2O-exact vs inference state: True",
                   "  future leakage events:       0"),
}
# the benchmarks run at --quick; every other module of
# benchmarks_torch.run.MODULES runs at its full config
ENTRY_QUICK = ("bench_feed", "bench_serve", "fig4_ne_scaling")
# the kernels each benchmark must launch on the card; it may launch no
# other, and the rest (the eleven host benchmarks among them) none
ENTRY_KERNELS = {"bench_kernels": ("delta_decode", "jagged_to_padded",
                                   "embedding_bag"),
                 "bench_device_mat": ("fused_densify",)}


def run_example(name: str, *args: str) -> list:
    """``python3 examples_torch/<name>.py <args> --device <DEVICE>`` from
    the checkout with ``PYTHONPATH=src``, as a user runs it: its stdout
    lines and seconds. Raises on a non-zero exit or past
    ``ENTRY_TIMEOUT_S`` (the process is killed)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, str(ROOT / "examples_torch" / f"{name}.py"),
           *args]
    if name != "quickstart":          # host-only: it takes no --device
        cmd += ["--device", DEVICE]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=ENTRY_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    require(out.returncode == 0,
            f"{' '.join(cmd[1:])} exited {out.returncode}:\n"
            f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return out.stdout.splitlines(), seconds


def line_with(lines: list, start: str, what: str) -> str:
    got = [ln for ln in lines if ln.startswith(start)]
    require(bool(got), f"{what}: no line starting {start!r} in:\n"
                       + "\n".join(lines[-20:]))
    return got[-1]


def seqrec_chain(ckpt: str) -> list:
    """``train_seqrec``: 60 steps (the loss falls from the first 10 to
    the last 10), then ``--resume --steps 70`` from the step-50
    checkpoint, then FULL DLRM-UIH for 20 steps: [(what, lines, s)]."""
    runs = []
    lines, s = run_example("train_seqrec", "--steps", "60", "--ckpt-dir", ckpt)
    first, last = map(float, line_with(lines, "loss ", "train_seqrec")
                      .split()[1::2])
    require(last < first, f"train_seqrec: loss {first} -> {last} did not fall")
    line_with(lines, "trained 60 steps", "train_seqrec")
    runs.append(("train_seqrec --steps 60", lines, s))
    lines, s = run_example("train_seqrec", "--steps", "70", "--ckpt-dir", ckpt,
                           "--resume")
    line_with(lines, "resumed from step 50", "train_seqrec --resume")
    line_with(lines, "trained 70 steps", "train_seqrec --resume")
    runs.append(("train_seqrec --resume --steps 70", lines, s))
    lines, s = run_example("train_seqrec", *ENTRY_FULL, "--ckpt-dir", ckpt)
    line_with(lines, f"trained {ENTRY_FULL[-1]} steps", "train_seqrec full")
    runs.append((f"train_seqrec {' '.join(ENTRY_FULL)}", lines, s))
    return runs


def check_streaming(lines: list) -> None:
    """Every example of the range trained once, every lease released."""
    handoff = line_with(lines, "catch-up handoff:", "train_streaming")
    done, total = handoff.split("-> ")[1].split()[0].split("/")
    require(done == total, f"train_streaming: {handoff}")
    gens = line_with(lines, "generations:", "train_streaming").split()
    acquired = gens[gens.index("leases") + 1]
    released = gens[gens.index("acquired") + 2]
    require(acquired == released, f"train_streaming: leases {acquired} "
                                  f"acquired, {released} released")
    line_with(lines, "freshness:", "train_streaming")


def entry_benchmarks(smi: str) -> dict:
    """The sixteen benchmarks of ``benchmarks_torch.run.MODULES`` in this
    process, in that order, through ``run_module`` on ``DEVICE``, each with
    the four kernels' counts set to 0 just before it and read just after:
    {module: {kernel: launches}}."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks_torch.run import MODULES, run_module
    from repro_torch.kernels.delta_decode import ops as dd
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.fused import ops
    from repro_torch.kernels.jagged import ops as jg

    wrappers = {"fused_densify": ops.fused_densify,
                "embedding_bag": eb.embedding_bag,
                "jagged_to_padded": jg.jagged_to_padded,
                "delta_decode": dd.delta_decode}
    counts = {}
    for name in [m.rsplit(".", 1)[1] for m in MODULES]:
        quick = name in ENTRY_QUICK
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        results = run_module(f"benchmarks_torch.{name}", quick=quick,
                             device=DEVICE)
        seconds = time.perf_counter() - t0
        counts[name] = {k: w.launches for k, w in wrappers.items()}
        for r in results:
            say("entry", f"{r.csv()} ({smi})")
        say("entry", f"benchmarks_torch.{name} ("
                     + ("quick" if quick else "full config")
                     + f") in {seconds:.3f} s; launches {counts[name]}")
        launched = {k for k, n in counts[name].items() if n}
        require(launched == set(ENTRY_KERNELS.get(name, ())),
                f"{name}: launches {counts[name]}")
        if name == "bench_kernels":
            exact = [r.derived["exact_match"] for r in results
                     if "exact_match" in r.derived]
            require(exact == [True], f"bench_kernels: exact_match {exact}")
    return counts


def entry_phase(smi: str) -> dict:
    """The five examples as subprocesses on the card, as a user runs them
    (``train_seqrec`` 60 steps, resumed to 70, then FULL for 20;
    ``train_streaming``, ``serve_retrieval``, ``streaming_vs_batch`` and
    ``quickstart`` beside it), each held by the lines it prints; then the
    sixteen benchmarks in this process, each launching the kernels it
    reaches and no other. Returns {benchmark: {kernel: launches}}."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt, ThreadPoolExecutor(5) as pool:
        chain = pool.submit(seqrec_chain, ckpt)
        others = {
            "train_streaming": pool.submit(run_example, "train_streaming",
                                           *ENTRY_STREAM),
            "serve_retrieval": pool.submit(run_example, "serve_retrieval",
                                           "--requests", str(ENTRY_REQUESTS)),
            "streaming_vs_batch": pool.submit(run_example,
                                              "streaming_vs_batch"),
            "quickstart": pool.submit(run_example, "quickstart"),
        }
        runs = [(name, *f.result()) for name, f in others.items()]
        runs += chain.result()
    for what, lines, seconds in runs:
        if what == "train_streaming":
            check_streaming(lines)
        for want in ENTRY_LINES.get(what, ()):
            line_with(lines, want, what)
        shown = [ln for ln in lines if ln and not ln.startswith("step ")]
        say("entry", f"examples_torch/{what} exited 0 in {seconds:.3f} s: "
                     + " | ".join(shown[-6:]) + f" ({smi})")
    say("entry", f"5 examples in {time.perf_counter() - t0:.3f} s ({smi})")
    return entry_benchmarks(smi)


# ---------------------------------------------------------------------------
# phase 4c: the launch layer's (arch x shape) cells on the card
# ---------------------------------------------------------------------------

CELL_PEAK_LIMIT = 70e9     # B: a cell whose reckoned peak reaches it stays
#                            on the dry run (the card holds 80 GB)
BF16_PEAK_FLOPS = 989.4e12  # H100 SXM5 dense bf16, NVIDIA data sheet
DRYRUN_TIMEOUT_S = 420.0
CELL_CALLS = {"train": 3, "serve": 10, "retrieval": 10,   # timed calls
              "prefill": 3, "decode": 10}
CELL_WARMUP = 2
CELL_FEED_BATCHES = 4      # batches compared between the placed and plain feeds
# a cell's step peak may exceed its reckoned peak by 10% and the CUDA
# libraries' workspaces, which a fake-tensor trace does not see
PEAK_SLACK, PEAK_SLACK_B = 1.10, 128 << 20


def start_dryrun(mesh: str, out: Path, arch: str = "", nice: int = 0):
    """``python -m repro_torch.launch.dryrun --all --mesh <mesh>`` (or
    ``--arch <arch>``) as a subprocess on the host's CPU (the card hidden
    from it, at ``nice``), writing ``out`` and its log beside it. Returns
    (process, log file, start time)."""
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    log = open(out.with_suffix(".log"), "w")
    which = ["--arch", arch] if arch else ["--all"]
    proc = subprocess.Popen(
        [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
         *which, "--mesh", mesh, "--force", "--out", str(out)],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
        preexec_fn=(lambda: os.nice(nice)) if nice else None)
    return proc, log, time.perf_counter()


def finish_dryrun(run, out: Path, meshes, archs=None) -> dict:
    """Wait for a ``start_dryrun`` run (within ``DRYRUN_TIMEOUT_S`` of its
    start) and require exit 0 and ``ok`` for every cell the dry run
    traces of ``archs`` (default all) on ``meshes``. Returns its results
    by key."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import archs_on

    proc, log, t0 = run
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                   - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    finally:
        log.close()
    tail = out.with_suffix(".log").read_text()[-2000:]
    require(rc == 0, f"dry run {' '.join(meshes)} exited {rc}:\n{tail}")
    results = json.loads(out.read_text())
    keys = [f"{a}|{s}|{m}" for m in meshes for a in archs_on(m, archs)
            for s in get_arch(a).shapes]
    bad = [k for k in keys if not results.get(k, {}).get("ok")]
    require(not bad, f"dry run cells not ok: {bad}")
    say("cells", f"dry run --mesh {'+'.join(meshes)}"
                 f"{' --arch ' + ','.join(archs) if archs else ''}: "
                 f"{len(keys)} cells ok in {time.perf_counter() - t0:.3f} s "
                 f"(exit 0)")
    return results


def cells_feed_check(sim, mesh) -> int:
    """DLRM-UIH's device-materialized feed opened with the FULL train
    cell's placements on the one-card mesh, against the same ordered feed
    opened without them: ``fused_densify`` launched as its transferred
    payloads call for, and its first ``CELL_FEED_BATCHES`` batches byte for
    byte the plain feed's. Returns the launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import SimSource, open_feed
    from repro_torch.kernels.fused import ops
    from repro_torch.launch.steps import build_cell

    spec = dataclasses.replace(feed_spec(), ordered=True,
                               source=SimSource(min_rows=BATCH))
    cell = build_cell(get_arch("dlrm-uih"), "train_batch", mesh)

    def drain(**placement):
        feed = open_feed(spec, sim, device=DEVICE, **placement)
        rec = recording_materializer(feed.prefetcher.materialize)
        feed.prefetcher.materialize = rec      # before the first get()
        ops.fused_densify.launches = 0          # count this feed only
        try:
            batches = list(itertools.islice(feed, CELL_FEED_BATCHES))
            torch.cuda.synchronize()
        finally:
            feed.close(timeout=30.0)
        return batches, rec, ops.fused_densify.launches, feed.client_stats

    plain = drain()[0]
    placed, rec, launches, cs = drain(cell=cell, mesh=mesh)
    check_device_feed("cells", rec, launches, cs, L_MAIN)
    require(len(placed) == len(plain) > 0,
            f"cells: {len(placed)} placed batches vs {len(plain)} plain")
    for a, b in zip(plain, placed):
        require(list(a) == list(b), "cells: placed batch keys differ")
        for k in a:
            require(type(b[k]) is torch.Tensor
                    and b[k].device.type == torch.device(DEVICE).type
                    and b[k].dtype == a[k].dtype and b[k].shape == a[k].shape
                    and torch.equal(b[k], a[k]),
                    f"cells: placed batch {k!r} differs from the plain feed")
    say("cells", f"open_feed(cell=dlrm-uih|train_batch, mesh=1x1): "
                 f"{len(placed)} batches byte for byte the plain feed's "
                 f"(a 1x1 placement is the identity: plain tensors on the "
                 f"card); fused_densify launched {launches} times")
    return launches


def run_cell(cell, family: str, reckoned: dict) -> dict:
    """``sample_args`` on the card, ``CELL_WARMUP`` calls, then the kind's
    timed calls under CUDA events; the outputs checked, the peak and the
    model-FLOPs utilization printed beside the reckoned roofline."""
    import torch

    from repro_torch.launch.sampling import sample_args

    key = f"{cell.arch_id}|{cell.shape_name}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = sample_args(cell, family, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    # a serving cell's float32 init before its bf16 cast is sampling's peak,
    # not the step's: the step's peak is taken from here on
    sample_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n = CELL_CALLS[cell.kind]
    losses = []

    def call():
        nonlocal args
        out = cell.step_fn(*args)
        if cell.kind == "train":     # the next step takes the new state
            args = (out[0], out[1], args[2])
            losses.append(out[2]["loss"])
        return out

    for _ in range(CELL_WARMUP):
        out = call()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        out = call()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / n
    peak = torch.cuda.max_memory_allocated()
    if cell.kind == "train":
        _, opt_state, metrics = out
        losses = [float(x) for x in losses]
        require(all(math.isfinite(float(v)) for v in metrics.values())
                and all(math.isfinite(x) for x in losses),
                f"{key}: metrics {metrics}, losses {losses}")
        require(len(set(losses)) > 1, f"{key}: the loss never changed")
        require(int(opt_state.step) == CELL_WARMUP + n,
                f"{key}: opt_state.step {int(opt_state.step)}")
        what = (f"losses {' '.join(f'{x:.5f}' for x in losses)}, "
                f"opt_state.step {int(opt_state.step)}")
    else:
        if cell.kind in ("prefill", "decode"):     # (logits, cache)
            out = out[0]
            want = (cell.args_spec[1]["tokens"].shape[0]
                    if cell.kind == "prefill" else cell.meta["tokens"],)
        else:
            want = {"serve": (cell.meta.get("batch"),),
                    "retrieval": (cell.meta.get("n_candidates"),)}[cell.kind]
        shape = tuple(out.shape)
        require(bool(torch.isfinite(out.float()).all())
                and (shape[:1] == want or shape[-1:] == want),
                f"{key}: output {shape}, finite "
                f"{bool(torch.isfinite(out.float()).all())}")
        what = f"output {shape} finite"
    roof, floor = reckoned["roofline"], reckoned["floor"]
    eager_ms = max(roof["t_compute_s"], roof["t_memory_s"]) * 1e3
    floor_ms = floor["t_bound_s"] * 1e3
    reckoned_peak = reckoned["memory"]["peak_bytes_per_chip"]
    # (a CPU rehearsal runs SMOKE widths against FULL reckonings: no check)
    require(ms >= floor_ms or DEVICE == "cpu",
            f"{key}: {ms:.6f} ms a call, under its floor {floor_ms:.6f} ms: "
            f"the floor's count is wrong")
    require(peak <= PEAK_SLACK * reckoned_peak + PEAK_SLACK_B
            or DEVICE == "cpu",
            f"{key}: step peak {peak} B over the reckoned {reckoned_peak} B: "
            f"the reckoning that decides which cells run undercounts")
    mfu = cell.model_flops / (ms / 1e3 * BF16_PEAK_FLOPS)
    say("cells", f"{key}: {ms:.6f} ms a {cell.kind} call (CUDA events, "
                 f"{n} calls after {CELL_WARMUP}); {what}; step peak {peak} B "
                 f"= {peak / reckoned_peak:.4f} x reckoned {reckoned_peak} B "
                 f"(sampling's peak {sample_peak} B); model_flops "
                 f"{cell.model_flops:.6e}, mfu {mfu:.6f}; floor "
                 f"{floor_ms:.6f} ms ({floor['bottleneck']}: "
                 f"{floor['compulsory_bytes_per_chip']:.6e} compulsory B, "
                 f"model flops), {ms / floor_ms:.3f} x floor; eager traffic "
                 f"{reckoned['cost']['flops']:.6e} flops, "
                 f"{reckoned['cost']['bytes accessed']:.6e} B = "
                 f"{eager_ms:.6f} ms; inputs sampled in {t_sample:.3f} s")
    del args, out
    return {"ms": ms, "peak": peak, "mfu": mfu, "floor_ms": floor_ms,
            "model_flops": cell.model_flops}


def cells_phase(sim, smi: str) -> int:
    """The launch layer on the card: every (arch x shape) cell, recsys and
    zoo, at FULL on the one-card mesh whose peak (reckoned by a fake-tensor
    trace of its step, ``dryrun --mesh one``, one process an arch side by
    side) is under ``CELL_PEAK_LIMIT`` runs at its own shape
    (``run_cell``); the rest stay on the dry run. A feed opened with a
    cell's placements is held against the plain feed (the production dry
    runs come with the ``mesh`` phase). Returns the feed's
    ``fused_densify`` launches. The one-rank process group the mesh
    stands over is destroyed at the end, so later phases run as before."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_cell

    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ones = {a: (start_dryrun("one", out_dir / f"dryrun_one_{a}_torch.json",
                             a), out_dir / f"dryrun_one_{a}_torch.json")
            for a in list_archs()}
    made_group = not dist.is_initialized()
    mesh = make_test_mesh(1, DEVICE)
    launches = cells_feed_check(sim, mesh)
    reckoned = {}
    for a, (run, out) in ones.items():
        reckoned.update(finish_dryrun(run, out, ["one"], [a]))
    say("cells", f"dry run --mesh one: {len(reckoned)} cells ok in "
                 f"{time.perf_counter() - t0:.3f} s, {len(ones)} processes")
    ran, stayed = [], []
    for arch in list_archs():
        spec = get_arch(arch)
        for shape in spec.shapes:
            r = reckoned[f"{arch}|{shape}|one"]
            peak = r["memory"]["peak_bytes_per_chip"]
            if peak >= CELL_PEAK_LIMIT:
                stayed.append(f"{arch}|{shape}")
                say("cells", f"{arch}|{shape}: reckoned peak {peak} B >= "
                             f"{CELL_PEAK_LIMIT:.0f} B: dry run only "
                             f"(counted {r['cost']['flops']:.6e} flops)")
                continue
            run_cell(build_cell(spec, shape, mesh), spec.family, r)
            ran.append(f"{arch}|{shape}")
            release(f"cell {arch}|{shape}")
    say("cells", f"{len(ran)} cells ran at their own FULL shapes, "
                 f"{len(stayed)} stayed on the dry run ({smi})")
    if made_group:
        dist.destroy_process_group()
    return launches


# ---------------------------------------------------------------------------
# phase 4d: the LM/MoE/GNN zoo on the card
# ---------------------------------------------------------------------------

ZOO_LMS = ("qwen3-4b", "qwen3-8b", "granite-8b", "qwen3-moe-30b-a3b",
           "deepseek-v2-lite-16b")
ZOO_BATCH = 4              # prompts served together
ZOO_PROMPT = 2048          # tokens a prompt
ZOO_DECODE = 32            # greedy decode steps after the prompt
# the last decode step's logits against prefill's over all 2080 tokens,
# relative Frobenius error: bf16 over 36 dense layers (PERF.md section 6)
ZOO_DENSE_RTOL = 0.05
# an MoE's top-k routing is discontinuous: bf16 rounding that differs
# between prefill's and decode's kernels flips near-tied experts, so its
# identity is held in float32 compute over the same bf16 weights, with
# every (token, expert) pair kept (capacity is per call: a pair dropped by
# one prefill and not the other would differ by definition; at random
# init the router is imbalanced, and capacity factor 2.0 still dropped
# pairs). At that capacity the float32 dispatch buffers of four prompts do
# not fit beside Qwen3-MoE's 61 GB of weights: the check takes the first
# prompt. An MoE's checks decode their tokens again under deterministic
# kernels (``deterministic``): with the combine's atomic adds the greedy
# tokens and the float32 sums, and so which near-tied experts flip,
# changed from run to run (PERF.md section 6).
ZOO_MOE_RTOL = 1e-3
# FULL width, depth cut: the float32 master, gradients and AdamW moments
# (16 B a parameter) of the full depth do not fit one card
ZOO_TRAIN = {"qwen3-4b": 12, "deepseek-v2-lite-16b": 3}
ZOO_TRAIN_SEQ = 4096
ZOO_TRAIN_STEPS = 5


@contextlib.contextmanager
def counted_drops():
    """Count the (token, expert) pairs the MoE dispatch drops while the
    block runs (each expert's pairs past its capacity): yields a one-entry
    list that holds the count."""
    from repro_torch.models import moe

    dispatch = moe.dispatch
    dropped = [0]

    def counting(idx, gate, cfg, cap, e_loc, offset=0):
        load = idx.reshape(-1).bincount(minlength=cfg.n_experts)
        dropped[0] += int((load - cap).clamp(min=0).sum())
        return dispatch(idx, gate, cfg, cap, e_loc, offset)

    moe.dispatch = counting
    try:
        yield dropped
    finally:
        moe.dispatch = dispatch


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels while the block runs (the MoE's combine,
    ``index_add``, adds without atomics), so a check whose value rests on
    float rounding has one value for a build and a card, not one a run:
    near-tied experts in the top-k follow the rounding."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def pad_cache(cache: dict, max_len: int) -> dict:
    """``prefill``'s cache (L, B, S, ...) zero-padded along S to the
    ``max_len`` positions decode writes into (the original is freed)."""
    for k in list(cache):
        c = cache[k]
        out = c.new_zeros((c.shape[0], c.shape[1], max_len, *c.shape[3:]))
        out[:, :, :c.shape[2]] = c
        cache[k] = out
        del c
    return cache


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def zoo_identity(params, seq, cfg, what: str) -> tuple:
    """Prefill ``seq[:, :ZOO_PROMPT]``, decode the rest of ``seq`` token by
    token (teacher-forced), and return the last step's logits and
    prefill's over all of ``seq``: (decode logits, prefill logits)."""
    import torch

    from repro_torch.models import transformer as T

    n = seq.shape[1]
    logits, cache = T.prefill(params, seq[:, :ZOO_PROMPT], cfg)
    cache = pad_cache(cache, n)
    for i in range(ZOO_PROMPT, n):
        logits, cache = T.decode_step(params, cache, seq[:, i],
                                      torch.full((seq.shape[0],), i,
                                                 device=seq.device), cfg)
    del cache
    want = T.prefill(params, seq, cfg)[0]
    require(bool(torch.isfinite(logits.float()).all())
            and bool(torch.isfinite(want.float()).all()),
            f"zoo {what}: non-finite logits")
    return logits, want


def greedy_decode(params, prompts, cfg) -> tuple:
    """``prefill`` of ``prompts`` and ``ZOO_DECODE`` greedy ``decode_step``s:
    (the last step's logits, the prompts and the tokens decoded)."""
    import torch

    from repro_torch.models import transformer as T

    logits, cache = T.prefill(params, prompts, cfg)
    cache = pad_cache(cache, ZOO_PROMPT + ZOO_DECODE)
    seq = [prompts]
    for i in range(ZOO_DECODE):
        nxt = logits.argmax(-1)
        seq.append(nxt[:, None])
        logits, cache = T.decode_step(
            params, cache, nxt,
            torch.full((prompts.shape[0],), ZOO_PROMPT + i, device=DEVICE),
            cfg)
    return logits, torch.cat(seq, dim=1)


def serve_lm(arch: str, smi: str) -> dict:
    """FULL ``arch`` in bf16 on the card: prefill, 32 greedy decode steps,
    the decode/prefill identity, times and peaks."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    cfg = get_arch(arch).full
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        params = T.init(cfg, seed=SEED, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    w_bytes = sum(t.numel() * t.element_size()
                  for t in params.parameters())
    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (ZOO_BATCH, ZOO_PROMPT)).astype(np.int64)).to(DEVICE)
    e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode(), counted_drops() as dropped:
        torch.cuda.reset_peak_memory_stats()
        e[0].record()
        logits, cache = T.prefill(params, prompts, cfg)
        e[1].record()
        torch.cuda.synchronize()
        prefill_peak = torch.cuda.max_memory_allocated()
        prefill_dropped = dropped[0]
        cache = pad_cache(cache, ZOO_PROMPT + ZOO_DECODE)
        cache_bytes = sum(c.numel() * c.element_size()
                          for c in cache.values())
        torch.cuda.reset_peak_memory_stats()
        seq = [prompts]
        nxt = logits.argmax(-1)
        e[2].record()
        for i in range(ZOO_DECODE):
            seq.append(nxt[:, None])
            logits, cache = T.decode_step(
                params, cache, nxt,
                torch.full((ZOO_BATCH,), ZOO_PROMPT + i, device=DEVICE), cfg)
            nxt = logits.argmax(-1)
        e[3].record()
        torch.cuda.synchronize()
        decode_peak = torch.cuda.max_memory_allocated()
        seq = torch.cat(seq, dim=1)                      # the 2080 tokens
        del cache
        # an MoE's checks take tokens decoded again under deterministic
        # kernels: with the combine's atomic adds, the greedy tokens and so
        # which near-tied experts flip changed from run to run
        moe = cfg.moe is not None
        with deterministic() if moe else contextlib.nullcontext():
            if moe:
                logits, seq = greedy_decode(params, prompts, cfg)
            before = dropped[0]
            want = T.prefill(params, seq, cfg)[0]
            bf16_err = rel_err(logits, want)
            bf16_argmax = float((logits.argmax(-1) == want.argmax(-1))
                                .float().mean())
            bf16_dropped = dropped[0] - before
            del want
            torch.cuda.empty_cache()
            if not moe:
                require(bf16_err <= ZOO_DENSE_RTOL,
                        f"zoo {arch}: decode's last logits differ from "
                        f"prefill's over {seq.shape[1]} tokens by "
                        f"{bf16_err} (relative Frobenius) > "
                        f"{ZOO_DENSE_RTOL}")
                check = f"held at <= {ZOO_DENSE_RTOL}"
            else:
                f32 = dataclasses.replace(
                    cfg, compute_dtype=torch.float32,
                    moe=dataclasses.replace(
                        cfg.moe,
                        capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
                dropped[0] = 0
                got, want = zoo_identity(params, seq[:1], f32, arch)
                f32_err = rel_err(got, want)
                f32_argmax = float((got.argmax(-1) == want.argmax(-1))
                                   .float().mean())
                require(dropped[0] == 0,
                        f"zoo {arch}: {dropped[0]} pairs dropped at a "
                        f"capacity of every token")
                require(f32_err <= ZOO_MOE_RTOL,
                        f"zoo {arch}: float32 decode's last logits differ "
                        f"from prefill's by {f32_err} > {ZOO_MOE_RTOL}")
                check = (f"reported (top-k routing flips under bf16 "
                         f"rounding); "
                         f"tokens decoded again under deterministic "
                         f"kernels; "
                         f"the first prompt in float32 compute over the same "
                         f"weights, every pair kept (0 dropped): "
                         f"{f32_err:.3e} <= {ZOO_MOE_RTOL}, argmax "
                         f"{f32_argmax:.3f}")
                del got, want
    prefill_ms = e[0].elapsed_time(e[1])
    step_ms = e[2].elapsed_time(e[3]) / ZOO_DECODE
    active = cfg.active_param_count()
    floor_ms = 2.0 * active * ZOO_BATCH * ZOO_PROMPT / BF16_PEAK_FLOPS * 1e3
    require(prefill_ms >= floor_ms,
            f"zoo {arch}: prefill {prefill_ms} ms under its floor {floor_ms}")
    say("zoo", f"{arch} serve (FULL, {cfg.n_layers} layers, bf16 weights "
               f"{w_bytes} B drawn on the card in {t_init:.3f} s): prefill "
               f"B={ZOO_BATCH} x {ZOO_PROMPT} {prefill_ms:.6f} ms (floor "
               f"2 x {active} active params x tokens / 989.4e12 = "
               f"{floor_ms:.6f} ms, {prefill_ms / floor_ms:.3f} x; peak "
               f"{prefill_peak} B, {prefill_dropped} pairs dropped); decode "
               f"{step_ms:.6f} ms a step over {ZOO_DECODE} greedy steps "
               f"(KV cache {cache_bytes} B at {ZOO_PROMPT + ZOO_DECODE} "
               f"positions, step peak {decode_peak} B); last step vs "
               f"prefill over {seq.shape[1]} tokens in bf16: relative "
               f"Frobenius {bf16_err:.6e}, argmax agreement "
               f"{bf16_argmax:.3f} ({bf16_dropped} pairs "
               f"dropped in that prefill), {check} ({smi})")
    del params, logits, seq, prompts
    return {"prefill_ms": prefill_ms, "floor_ms": floor_ms,
            "step_ms": step_ms, "rel_err": bf16_err}


def train_lm(arch: str, n_layers: int, smi: str) -> dict:
    """FULL-width ``arch`` cut to ``n_layers`` trained ``ZOO_TRAIN_STEPS``
    AdamW steps through ``make_train_step`` at seq ``ZOO_TRAIN_SEQ``,
    batch 1: a finite loss that changes, a finite gradient norm, the
    optimizer's step count."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             make_train_step)

    cfg = dataclasses.replace(get_arch(arch).full, n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = T.init(cfg, seed=SEED, device=DEVICE)
    n_params = sum(t.numel() for t in params.parameters())
    opt = adamw_init(params)

    def loss(p, batch):
        return T.loss_fn(p, batch["tokens"], batch["targets"], cfg)

    step = make_train_step(loss, AdamWConfig())
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab, (1, ZOO_TRAIN_SEQ + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(DEVICE),
             "targets": torch.from_numpy(toks[:, 1:]).to(DEVICE)}
    losses, norms = [], []
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for i in range(ZOO_TRAIN_STEPS):
        if i == 1:
            e0.record()
        params, opt, metrics = step(params, opt, batch)
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    e1.record()
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses + norms),
            f"zoo {arch} train: losses {losses}, grad norms {norms}")
    require(len(set(losses)) > 1, f"zoo {arch} train: the loss never changed")
    require(int(opt.step) == ZOO_TRAIN_STEPS,
            f"zoo {arch} train: opt_state.step {int(opt.step)}")
    ms = e0.elapsed_time(e1) / (ZOO_TRAIN_STEPS - 1)
    say("zoo", f"{arch} train (FULL width, {n_layers} of "
               f"{get_arch(arch).full.n_layers} layers, {n_params} float32 "
               f"params): {ZOO_TRAIN_STEPS} AdamW steps at seq "
               f"{ZOO_TRAIN_SEQ}, batch 1; losses "
               f"{' '.join(f'{x:.5f}' for x in losses)}, grad norms "
               f"{' '.join(f'{x:.4f}' for x in norms)}, opt_state.step "
               f"{int(opt.step)}; {ms:.3f} ms a step after the first "
               f"({1e3 / ms:.3f} steps/s), peak {peak} B ({smi})")
    del params, opt, batch
    return {"ms": ms, "peak": peak}


def zoo_phase(smi: str) -> dict:
    """The five FULL LMs served and two trained at FULL width, one model's
    tensors released before the next. None of the four kernels is on the
    zoo's path: their counts must not move."""
    from repro_torch.kernels.delta_decode import ops as dd
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.fused import ops
    from repro_torch.kernels.jagged import ops as jg

    wrappers = (ops.fused_densify, eb.embedding_bag, jg.jagged_to_padded,
                dd.delta_decode)
    before = [w.launches for w in wrappers]
    out = {}
    for arch in ZOO_LMS:
        out[f"{arch}|serve"] = serve_lm(arch, smi)
        release(f"zoo {arch} serve")
    for arch, n_layers in ZOO_TRAIN.items():
        out[f"{arch}|train"] = train_lm(arch, n_layers, smi)
        release(f"zoo {arch} train")
    moved = [w.launches - n for w, n in zip(wrappers, before)]
    require(not any(moved), f"zoo: kernel launches {moved} on its path")
    say("zoo", "0 launches of the four kernels (none is on the zoo's path)")
    return out


# ---------------------------------------------------------------------------
# phase 4e: the zoo's rank-local programs on a (2, 16) mesh of rank threads
# ---------------------------------------------------------------------------

MESH_SHAPE = (2, 16)       # ("data", "model"): the pod's model degree
MESH_LAYERS = 2            # FULL width, depth cut (every DeepSeek layer is MoE)
MESH_CELLS = {             # cut from LM_SHAPES: prefill's length, the batches
    "prefill_32k": {"batch": 2, "seq_len": 4096},
    "decode_32k": {"batch": 2},                   # the full 32,768 positions
    "long_500k": {"batch": 1},                    # the full 524,288 positions
}
MESH_POSITIONS = {"decode_32k": (1234, 30_000),   # owned by two model ranks
                  "long_500k": (400_000,)}        # by rank (1, 8) of (2, 16)
MESH_RTOL = 1e-3           # float32 compute: logits and written cache entries
MESH_PROD = ("pod", "multipod")


def mesh_args(spec, shape: str, cfg, params) -> tuple:
    """A cell's global arguments on the card: bf16 weights, seeded tokens,
    and for decode a seeded random cache of the cell's length (a cache
    whose every entry was written, as after a prefill) at
    ``MESH_POSITIONS``."""
    import torch

    from repro_torch.models import transformer as T

    shp = spec.shapes[shape]
    b, sl = shp["batch"], shp["seq_len"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    if shp["kind"] == "prefill":
        return (params, {"tokens": torch.randint(
            0, cfg.vocab, (b, sl), generator=gen, device=DEVICE,
            dtype=torch.int32)})
    cache = T.init_kv_cache(cfg, b, sl, device=DEVICE)
    for c in cache.values():
        c.normal_(generator=gen).mul_(0.5)
    return (params, cache, {
        "token": torch.randint(0, cfg.vocab, (b,), generator=gen,
                               device=DEVICE, dtype=torch.int32),
        "position": torch.tensor(MESH_POSITIONS[shape], dtype=torch.int32,
                                 device=DEVICE)})


def one_rank(kind: str, args: tuple, cfg):
    """The single-device program on the same arguments (a decode on a
    copy of the cache): (outputs, ms)."""
    import torch

    from repro_torch.models import transformer as T

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        if kind == "prefill":
            e0.record()
            out = T.prefill(args[0], args[1]["tokens"], cfg)
        else:
            cache = {k: v.clone() for k, v in args[1].items()}
            e0.record()
            out = T.decode_step(args[0], cache, args[2]["token"],
                                args[2]["position"], cfg)
        e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def cache_check(rank_cache: dict, want: dict, given, positions,
                spec_sh: dict, mesh) -> dict:
    """One rank's cache block against the same block of the one-rank
    program's: the entries this call wrote (prefill: all; decode: each
    row's position, in every layer) as sums of squares, and how many of
    the others differ from what the rank was given (must be none)."""
    import torch

    from repro_torch.launch import shardings as SH
    from repro_torch.models.parallel import rank_of, size_of

    out = {"diff_sq": 0.0, "want_sq": 0.0, "max_abs": 0.0, "untouched": 0,
           "written": 0, "bitwise": 0}
    for k, got in rank_cache.items():
        sp = spec_sh[k]
        w = SH.local_block(want[k], sp, mesh)
        if positions is None:
            written = torch.ones(got.shape[1:3], dtype=torch.bool,
                                 device=got.device)
        else:
            b_loc, s_loc = got.shape[1:3]
            b_lo = rank_of(mesh, sp.dim_axes(1)) * b_loc
            s_lo = rank_of(mesh, sp.dim_axes(2)) * s_loc
            s_all = s_loc * size_of(mesh, sp.dim_axes(2))
            pos = positions.long().clamp(0, s_all - 1)[b_lo:b_lo + b_loc]
            written = (s_lo + torch.arange(s_loc, device=got.device)[None, :]
                       == pos[:, None])
            before = SH.local_block(given[k], sp, mesh)
            keep = ~written.reshape(1, *written.shape,
                                    *([1] * (got.ndim - 3)))
            out["untouched"] += int(((got != before) & keep).sum())
        g = got[:, written].float()
        r = w[:, written].float()
        out["diff_sq"] += float((g - r).square().sum())
        out["want_sq"] += float(r.square().sum())
        if g.numel():
            out["max_abs"] = max(out["max_abs"], float((g - r).abs().max()))
        out["written"] += g.numel()
        out["bitwise"] += int((g == r).sum())
    return out


def mesh_cell(tm, spec, shape: str, cfg, params, param_blocks: dict
              ) -> dict:
    """One cell of ``spec`` on the rank-thread mesh ``tm`` against the
    single-device program on the same arguments: logits gathered from the
    ranks' vocabulary blocks (relative Frobenius error, argmax agreement),
    every rank's cache block (``cache_check``), ms a call of each. A
    rank's block of ``params`` under a placement it has cut before is
    taken from ``param_blocks``."""
    import torch

    from repro_torch.launch import shardings as SH
    from repro_torch.launch.sampling import local_args
    from repro_torch.tree import tree_leaves
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.parallel import rank_of

    kind = spec.shapes[shape]["kind"]
    clock = [time.perf_counter()]

    def lap():
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    args = mesh_args(spec, shape, cfg, params)
    want, one_ms = one_rank(kind, args, cfg)
    laps = {"one rank": lap()}
    ranks: dict = {}

    def prepare(rank, mesh):
        cell = build_cell(spec, shape, mesh, cfg_override=cfg)
        key = (rank, str(tree_leaves(cell.in_shardings[0],
                                     is_leaf=SH.is_spec)))
        if key not in param_blocks:
            param_blocks[key] = local_args(
                cell, (params,) + (None,) * (len(args) - 1), mesh)[0]
        rest = local_args(cell, (None,) + args[1:], mesh)[1:]
        ranks[rank] = (cell, (param_blocks[key], *rest))

    def step(rank, mesh):
        cell, local = ranks[rank]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        got = cell.step_fn(*local)
        e1.record()
        ranks[rank] = (cell, got, (e0, e1))

    def compare(rank, mesh):
        cell, (logits, cache), _ = ranks.pop(rank)
        lsp, csp = cell.out_shardings
        rows = rank_of(mesh, lsp.dim_axes(0)) * logits.shape[0]
        cols = mesh.get_local_rank("model") * logits.shape[1]
        given = (None, None) if kind == "prefill" else (
            args[1], args[2]["position"])
        return (rows, cols, logits.float(),
                cache_check(cache, want[1], *given, csp, mesh))

    tm.run(prepare)
    torch.cuda.synchronize()
    laps["blocks"] = lap()
    tm.run(step)
    torch.cuda.synchronize()
    laps["step"] = lap()
    marks = [m for _, _, m in ranks.values()]
    first = marks[0][0]
    mesh_ms = (max(first.elapsed_time(e1) for _, e1 in marks)
               - min(first.elapsed_time(e0) for e0, _ in marks))
    parts = tm.run(compare)
    logits = torch.empty(want[0].shape, dtype=torch.float32, device=DEVICE)
    for rows, cols, block, _ in parts:
        logits[rows:rows + block.shape[0], cols:cols + block.shape[1]] = block
    sums = {k: sum(p[3][k] for p in parts) for k in parts[0][3]}
    sums["max_abs"] = max(p[3]["max_abs"] for p in parts)
    laps["checks"] = lap()
    return {"mesh_ms": mesh_ms, "one_ms": one_ms, "laps": laps,
            "logits_rel": rel_err(logits, want[0]),
            "argmax": float((logits.argmax(-1) == want[0].argmax(-1))
                            .float().mean()),
            "cache_rel": math.sqrt(sums["diff_sq"] / sums["want_sq"]),
            "cache": sums}


def mesh_lm(tm, arch: str, smi: str) -> dict:
    """FULL ``arch`` cut to ``MESH_LAYERS`` layers, bf16 weights drawn on
    the card, its three serving cells on the rank-thread mesh in float32
    compute over the bf16 weights at a capacity no MoE pair exceeds (held
    to ``MESH_RTOL``) and in the cell's own bf16 (reported)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    base = get_arch(arch)
    full = dataclasses.replace(base.full, n_layers=MESH_LAYERS)
    spec = dataclasses.replace(base, shapes={
        k: {**base.shapes[k], **v} for k, v in MESH_CELLS.items()})
    f32 = dataclasses.replace(full, compute_dtype=torch.float32)
    if full.moe is not None:
        f32 = dataclasses.replace(f32, moe=dataclasses.replace(
            full.moe, capacity_factor=full.moe.n_experts / full.moe.top_k))
    with torch.no_grad():
        params = tree_map(lambda p: p.detach(), T.init(
            full, seed=SEED, device=DEVICE, dtype=torch.bfloat16))
    out, param_blocks = {}, {}
    for shape in MESH_CELLS:
        for mode, cfg in (("float32", f32), ("bf16", full)):
            r = mesh_cell(tm, spec, shape, cfg, params, param_blocks)
            c = r["cache"]
            ok = (r["logits_rel"] <= MESH_RTOL and r["cache_rel"] <= MESH_RTOL
                  and c["untouched"] == 0)
            if mode == "float32":
                require(ok, f"mesh {arch}|{shape} float32: logits "
                            f"{r['logits_rel']}, written cache entries "
                            f"{r['cache_rel']} (relative Frobenius, limit "
                            f"{MESH_RTOL}), {c['untouched']} entries it did "
                            f"not write differ")
            say("mesh", f"{arch}|{shape} {mode} on {MESH_SHAPE} "
                        f"({tm.world} rank threads, {MESH_LAYERS} layers): "
                        f"logits vs one rank, relative Frobenius "
                        f"{r['logits_rel']:.3e}, argmax {r['argmax']:.3f}; "
                        f"cache entries written {c['written']} "
                        f"({c['bitwise']} bitwise equal), relative "
                        f"{r['cache_rel']:.3e}, max abs {c['max_abs']:.3e}, "
                        f"{c['untouched']} of the rest differ"
                        + (f" (held at <= {MESH_RTOL})" if mode == "float32"
                           else " (reported)")
                        + f"; {r['mesh_ms']:.3f} ms a call over the rank "
                        f"threads on one card (not a per-chip time), one "
                        f"rank {r['one_ms']:.3f} ms; host seconds: "
                        + ", ".join(f"{k} {v:.3f}"
                                    for k, v in r["laps"].items())
                        + f" ({smi})")
            out[f"{arch}|{shape}|{mode}"] = r
    del params, param_blocks
    return out


def start_production_dryruns() -> dict:
    """``dryrun --mesh pod`` and ``--mesh multipod``, one subprocess an arch
    and mesh, all started at once, below the rank threads' priority (nice
    10): {(mesh, arch): (run, out)}."""
    from repro_torch.configs import list_archs

    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = {}
    for m in MESH_PROD:
        for a in list_archs():
            out = out_dir / f"dryrun_{m}_{a}_torch.json"
            runs[(m, a)] = (start_dryrun(m, out, a, nice=10), out)
    return runs


def finish_production_dryruns(runs: dict, t0: float) -> dict:
    """Wait for ``start_production_dryruns``; print each zoo cell's traced
    per-chip peak, whether it fits the card's 80 GB, and its bound."""
    from repro_torch.configs import get_arch

    results = {}
    for (m, a), (run, out) in runs.items():
        results.update(finish_dryrun(run, out, [m], [a]))
    say("mesh", f"production dry run: {len(results)} cells ok on "
                f"{' and '.join(MESH_PROD)} in "
                f"{time.perf_counter() - t0:.3f} s, {len(runs)} processes")
    for key, e in results.items():
        fam = get_arch(e["arch"]).family
        roof = e["roofline"]
        terms = {"bytes": roof["t_memory_s"], "FLOPs": roof["t_compute_s"],
                 "the link": roof["t_collective_s"]}
        peak = e["memory"]["peak_bytes_per_chip"]
        say("mesh", f"dry run {key} ({fam}): {e['chips']} chips, logical "
                    f"{e['memory']['args_logical_bytes_per_chip']} B/chip, "
                    f"peak {peak} B/chip ("
                    + ("fits" if peak < 80e9 else "does not fit")
                    + f" 80 GB), collectives {e['collectives']['counts']} "
                    f"({e['collectives']['link_bytes']:.0f} link B/chip), "
                    f"bound by {max(terms, key=terms.get)}")
    return results


def roofline_reports(runs: dict, smi: str) -> dict:
    """``benchmarks_torch.roofline_report`` over the production dry runs'
    files, for each mesh: one roofline row for each ``ok`` cell, three
    hillclimb picks among them. Writes each report beside the files
    (``build/dryrun/roofline_report_<mesh>.md``), prints the picks and
    returns {mesh: picks}."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks_torch import roofline_report

    picks = {}
    for m in MESH_PROD:
        paths = [out for (mm, _), (_, out) in runs.items() if mm == m]
        ok = [k for k, v in roofline_report.read_results(paths).items()
              if v.get("ok") and v["mesh"] == m]
        rows = roofline_report.roofline_table(m, paths).splitlines()[2:]
        require(len(rows) == len(ok) > 0,
                f"roofline_report {m}: {len(rows)} rows for {len(ok)} cells")
        md = paths[0].parent / f"roofline_report_{m}.md"
        md.write_text(roofline_report.report(m, paths) + "\n")
        picks[m] = roofline_report.pick_hillclimb(m, paths)
        named = {f"{cell}|{m}" for cell in picks[m].values()}
        require(len(picks[m]) == 3 and named <= set(ok),
                f"roofline_report {m}: picks {picks[m]}")
        say("mesh", f"roofline_report --mesh {m}: {len(rows)} rows for "
                    f"{len(ok)} ok cells, written to {md}; hillclimb picks: "
                    + ", ".join(f"{k} {v}" for k, v in picks[m].items())
                    + f" ({smi})")
    return picks


def mesh_phase(smi: str) -> dict:
    """The five FULL-width LMs (depth cut) serve their three cells as
    rank-local programs on a (2, 16) mesh of rank threads on the card,
    held against one rank; the production dry runs (88 cells) run on the
    host's CPU meanwhile. None of the four kernels is on the path."""
    from repro_torch.kernels.delta_decode import ops as dd
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.fused import ops
    from repro_torch.kernels.jagged import ops as jg
    from repro_torch.launch.threaded import ThreadedMesh

    wrappers = (ops.fused_densify, eb.embedding_bag, jg.jagged_to_padded,
                dd.delta_decode)
    t0 = time.perf_counter()
    runs = start_production_dryruns()
    for w in wrappers:
        w.launches = 0
    out = {}
    with ThreadedMesh(MESH_SHAPE, device_type=DEVICE) as tm:
        for arch in ZOO_LMS:
            out.update(mesh_lm(tm, arch, smi))
            release(f"mesh {arch}")
    counts = [w.launches for w in wrappers]
    require(not any(counts), f"mesh: kernel launches {counts} on its path")
    say("mesh", f"{len(out) // 2} cells x (float32, bf16) on {MESH_SHAPE} in "
                f"{time.perf_counter() - t0:.3f} s; 0 launches of the four "
                f"kernels (none is on the path) ({smi})")
    out["dryrun"] = finish_production_dryruns(runs, t0)
    out["hillclimb"] = roofline_reports(runs, smi)
    return out


# ---------------------------------------------------------------------------
# phase 4f: train cells' rank-local steps on a (2, 2) mesh of rank processes
# ---------------------------------------------------------------------------

MESH_TRAIN_SHAPE = (2, 2)  # ("data", "model"): 4 rank processes on the card
MESH_TRAIN_STEPS = 2       # AdamW steps, each held against one rank's
MESH_TRAIN_LOSS_RTOL = 1e-4   # the global loss and gradient norm, relative
MESH_TRAIN_RTOL = 1e-3     # each parameter and first-moment leaf, relative
#                            Frobenius (the mesh phase's limit)
MESH_TRAIN_TIMEOUT_S = 600.0
# the card holds about 14x a cell's parameter bytes at once: the 4 ranks'
# steps (~9x: row-sharded tables and TP weights whole over "data", their
# gradients, ZeRO moments, AdamW's and the all-gather's temporaries), the
# shared parameters (1x) and the one-rank states after each step (4x); a
# cell over CELL_PEAK_LIMIT keeps those states in host memory instead
MESH_TRAIN_HOLD = 14
# FULL widths in float32 compute; what each cell cuts to fit 4 rank
# processes and the one-rank reference on one card (PERF.md section 4)
MESH_TRAIN_LM = {"n_layers": 2, "batch": 2, "seq_len": 1024}
MESH_TRAIN_CELLS = (
    # FULL's 30.7 GB of tables need 123 GB of float32 training state
    ("two-tower-retrieval", "train_batch",
     {"batch": 32_768, "item_vocab": 1_000_448, "user_vocab": 2_000_896}),
    ("dcn-v2", "train_batch", {}),
    ("dien", "train_batch", {"batch": 32_768}),
    ("bert4rec", "train_batch", {"batch": 4_096}),
    *((arch, "train_4k", MESH_TRAIN_LM) for arch in ZOO_LMS),
    ("meshgraphnet", "full_graph_sm", {}),
    ("meshgraphnet", "minibatch_lg", {}),
    ("meshgraphnet", "molecule", {}),
)
# MeshGraphNet's first-layer gradient (node_encoder/w0, under 15 blocks)
# is not resolved to 1e-3 in float32 on the card, where one rank's and 4
# ranks' float32 gradients of it differ by more than their float64 ones
# (PERF.md section 6): its cells are held in float64 compute and
# reported in float32
MESH_TRAIN_F64 = ("meshgraphnet",)
MESH_TRAIN_FEED_BATCH = 32     # DLRM-UIH from its placed feed: the main path's
MESH_TRAIN_LEFT_OUT = (("meshgraphnet", "ogb_products"),)   # > 70 GB reckoned


def mesh_train_sim():
    """(config, days) of the sim DLRM-UIH's placed feed reads: 8 users of
    ``build_sim``'s, so each rank process builds its own copy quickly (a
    sim holds locks and is not sent)."""
    from repro_torch.core import events as ev
    from repro_torch.core.simulation import SimConfig

    return SimConfig(
        stream=ev.StreamConfig(n_users=8, n_items=100_000, days=30,
                               events_per_user_day_mean=80, seed=SEED),
        stripe_len=256, lookback_ms=24 * ev.MS_PER_DAY, seed=SEED), 29


def mesh_train_over(arch: str, reduced: dict, dtype=None) -> dict:
    """A cell's config overrides: its cuts, the compute dtype (float32 by
    default) and, for an MoE, a capacity no (token, expert) pair
    exceeds."""
    import torch

    from repro_torch.configs import get_arch

    over = {**reduced, "compute_dtype": dtype or torch.float32}
    moe = getattr(get_arch(arch).full, "moe", None)
    if moe is not None:
        over["capacity_factor"] = moe.n_experts / moe.top_k
    return over


def mesh_train_param_bytes(cell) -> int:
    """A train cell's parameter bytes, from its argument specs."""
    from repro_torch.launch import shardings as SH
    from repro_torch.tree import tree_leaves

    return sum(s.nbytes for s in tree_leaves(cell.args_spec[0],
                                             is_leaf=SH.is_spec))


def mesh_train_cell(pm, one, arch: str, shape: str, reduced: dict,
                    smi: str, host, feed=None, dtype=None,
                    held: bool = True) -> dict:
    """``arch``'s ``shape`` cell at FULL width with ``reduced``'s cuts, in
    ``dtype`` (float32 by default) compute under deterministic kernels
    (CUDA's atomic adds in scatter and embedding backwards would change
    the sums from run to run): its one-rank AdamW steps on the one-card
    mesh ``one``
    (states kept on the card, or in host memory where ``MESH_TRAIN_HOLD``
    says they do not fit), then the same steps as the
    rank-local program of the 4 rank processes of ``pm`` on the same
    parameters and batches (``feed``: the placed feed's, opened in each
    rank), held to ``MESH_TRAIN_LOSS_RTOL`` and ``MESH_TRAIN_RTOL`` (or,
    not ``held``, reported)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.sampling import sample_args
    from repro_torch.testing import mesh_train as MT
    from repro_torch.tree import tree_map

    spec = get_arch(arch)
    over = mesh_train_over(arch, reduced, dtype)
    moe = getattr(spec.full, "moe", None)
    key = f"{arch}|{shape}"
    clock = [time.perf_counter()]

    def lap():
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cell = MT.build_train_cell(arch, shape, over, one)
    args = sample_args(cell, spec.family, seed=SEED, device=DEVICE)
    params = tree_map(lambda t: t.detach(), args[0])
    p_bytes = mesh_train_param_bytes(cell)
    if MESH_TRAIN_HOLD * p_bytes <= CELL_PEAK_LIMIT:
        host = None            # the states fit the card beside the ranks
    else:
        host.reset()
    if feed is None:
        batch = args[2]
        batches = [batch] * MESH_TRAIN_STEPS
    else:
        batch = None
        batches = MT.feed_batches(feed, cell, None, MESH_TRAIN_STEPS, DEVICE)
    del args          # sample_args' zero moments: reference_steps makes its own
    torch.cuda.synchronize()
    laps = {"inputs": lap()}
    ref = MT.reference_steps(cell, params, batches, host=host,
                             deterministic=True)
    one_peak = torch.cuda.max_memory_allocated()
    del cell, batches
    gc.collect()
    torch.cuda.empty_cache()
    laps["one rank"] = lap()
    inputs = [params, batch]
    del params, batch        # freed once the ranks hold their blocks
    got = MT.train_on_mesh(pm, arch, shape, over, inputs, ref, True, feed)
    laps["4 ranks"] = lap()

    def rel(a, b):
        return abs(a - b) / abs(b)

    parts = []
    worst_all = 0.0
    for i, want in enumerate(ref):
        steps = [r["steps"][i] for r in got]
        loss = max(rel(s["loss"], want["loss"]) for s in steps)
        norm = max(rel(s["grad_norm"], want["grad_norm"]) for s in steps)
        require(not held or (loss <= MESH_TRAIN_LOSS_RTOL
                             and norm <= MESH_TRAIN_LOSS_RTOL),
                f"mesh_train {key} step {i + 1}: loss {loss:.3e}, gradient "
                f"norm {norm:.3e} relative to one rank (limit "
                f"{MESH_TRAIN_LOSS_RTOL})")
        worst = {}
        for k in ("params", "params_rest", "m"):
            rank, leaf = max(((r, n) for r in range(len(steps))
                              for n in steps[r][k]),
                             key=lambda rn: steps[rn[0]][k][rn[1]])
            worst[k] = (leaf, rank, steps[rank][k][leaf])
            if k != "params" and held:
                require(worst[k][2] <= MESH_TRAIN_RTOL,
                        f"mesh_train {key} step {i + 1}: {k} leaf {leaf!r} "
                        f"of rank {rank} at {worst[k][2]:.3e} relative "
                        f"Frobenius (limit {MESH_TRAIN_RTOL})")
                worst_all = max(worst_all, worst[k][2])
        # parameter elements whose Adam direction moved on a near-zero
        # gradient (testing.mesh_train.param_err), counted and bounded
        flips = {}
        for r, st in enumerate(steps):
            for leaf, (n, bad, far) in st["explained"].items():
                require(not held or (bad == 0 and far <= 2.01),
                        f"mesh_train {key} step {i + 1}: leaf {leaf!r} of "
                        f"rank {r} has {bad} elements that moved by over "
                        f"{MT.MOVED} lr where Adam's direction is not "
                        f"ill-conditioned for the ranks' largest gradient "
                        f"difference, and moved {far:.3f} x the summed lr "
                        f"(at most 2)")
                flips[leaf] = max(flips.get(leaf, 0), n)
        wl, wr, we = worst["params"]
        parts.append(
            f"step {i + 1}: loss {want['loss']:.6f} ({loss:.3e} rel), "
            f"grad norm {want['grad_norm']:.6f} ({norm:.3e} rel), worst "
            f"params leaf {wl} (rank {wr}) {we:.3e}, "
            f"{steps[wr]['params_rest'][wl]:.3e} without its "
            f"{steps[wr]['explained'].get(wl, (0,))[0]} elements moved on a "
            f"near-zero gradient (worst without: {worst['params_rest'][0]} "
            f"{worst['params_rest'][2]:.3e}; such elements a leaf, most "
            f"on a rank: {flips or 'none'}), worst "
            f"first-moment leaf {worst['m'][0]} (rank {worst['m'][1]}) "
            f"{worst['m'][2]:.3e}, {max(s['ms'] for s in steps):.3f} ms "
            f"(slowest rank)")
    peaks = [r["peak"] for r in got]
    launches = {k: [r["launches"][k] for r in got] for k in got[0]["launches"]}
    say("mesh_train",
        f"{key} on {MESH_TRAIN_SHAPE}, {pm.world} rank processes, reduced "
        f"{reduced}" + (", batches from the placed feed" if feed else "")
        + f" ({over['compute_dtype']} compute, "
        + ("held" if held else "reported, not held")
        + ", TF32 off, deterministic kernels"
        + (f", capacity factor {over['capacity_factor']:g}"
           if moe is not None else "")
        + f"; {p_bytes} B of parameters, the one-rank states kept in "
        + ("device" if host is None else "host") + " memory"
        + f"): " + "; ".join(parts) + f"; rank peaks {peaks} B, sum "
        f"{sum(peaks)} B; one rank's peak {one_peak} B; kernel launches a "
        f"rank {launches}; host seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in laps.items())
        + " (one rank's steps "
        + ", ".join(f"{sum(w['seconds'][k] for w in ref):.3f} {k}"
                    for k in ("step", "keep"))
        + "; slowest rank's "
        + ", ".join(f"{max(r['seconds'][k] for r in got):.3f} {k}"
                    for k in got[0]["seconds"]) + ")"
        + f" (ranks that share the card: rank-process times, not "
        f"per-chip ones) ({smi})")
    return {"peaks": peaks, "one_peak": one_peak,
            "worst": worst_all if held else 0.0,
            "launches": launches, "seconds": laps}


def reckoned_peak(arch: str, shape: str):
    """The one-card peak the ``cells`` phase's dry run reckoned for
    ``arch``'s ``shape`` at FULL, or ``None`` without its file."""
    path = ROOT / "build" / "dryrun" / f"dryrun_one_{arch}_torch.json"
    if not path.exists():
        return None
    entry = json.loads(path.read_text()).get(f"{arch}|{shape}|one", {})
    return entry.get("memory", {}).get("peak_bytes_per_chip")


def mesh_train_phase(smi: str) -> dict:
    """The train cells' rank-local steps (collectives inside the backward,
    ZeRO moments, row-sharded tables, tensor- and expert-parallel LMs, a
    GNN's edges over every rank) on a (2, 2) mesh of 4 rank processes that
    share the card (``launch.procmesh.ProcessMesh``), each cell held
    against its one-rank steps; DLRM-UIH takes its batches from the
    cell-placed feed, opened in every rank (``fused_densify`` launches
    there). Returns each cell's readings."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.procmesh import ProcessMesh
    from repro_torch.testing import mesh_train as MT

    t0 = time.perf_counter()
    made_group = not dist.is_initialized()
    one = make_test_mesh(1, DEVICE)
    out = {}
    for arch, shape in MESH_TRAIN_LEFT_OUT:
        peak = reckoned_peak(arch, shape)
        say("mesh_train", f"{arch}|{shape} left out: reckoned one-card peak "
                          + (f"{peak} B" if peak else "not read (no dry run "
                             "file)") + f" >= {CELL_PEAK_LIMIT:.0f} B")
    cells = [("dlrm-uih", "train_batch", {"batch": MESH_TRAIN_FEED_BATCH})]
    cells += list(MESH_TRAIN_CELLS)
    big = max(mesh_train_param_bytes(MT.build_train_cell(
        a, s, mesh_train_over(a, r), one)) for a, s, r in cells)
    # each step's parameters and first moments of the largest cell that
    # keeps them on the host (None: every cell keeps them on the card)
    host = (MT.HostStates(2 * MESH_TRAIN_STEPS * big)
            if MESH_TRAIN_HOLD * big > CELL_PEAK_LIMIT else None)
    say("mesh_train", f"largest cell {big} B of parameters; "
                      + ("no host memory for one-rank states" if host is None
                         else f"{host.buf.numel()} B of host memory "
                              f"page-locked for one-rank states in "
                              f"{time.perf_counter() - t0:.3f} s"))
    try:
        with ProcessMesh(MESH_TRAIN_SHAPE, device_type=DEVICE,
                         timeout=MESH_TRAIN_TIMEOUT_S) as pm:
            say("mesh_train", f"{pm.world} rank processes joined the "
                              f"shared-card group on {DEVICE} in "
                              f"{time.perf_counter() - t0:.3f} s")
            mesh_train_cells(pm, one, smi, host, out)
    finally:
        if host is not None:
            host.close()
    if made_group:
        dist.destroy_process_group()
    say("mesh_train", f"{len(out)} runs on {MESH_TRAIN_SHAPE} in "
                      f"{time.perf_counter() - t0:.3f} s, worst leaf "
                      f"{max(r['worst'] for r in out.values()):.3e} (limit "
                      f"{MESH_TRAIN_RTOL}) ({smi})")
    return out


def mesh_train_cells(pm, one, smi: str, host, out: dict) -> None:
    """``mesh_train_phase``'s cells on ``pm``, in order, into ``out``:
    DLRM-UIH from its placed feed (``fused_densify`` must launch in every
    rank), then ``MESH_TRAIN_CELLS``."""
    import dataclasses

    import torch

    from repro_torch.data import SimSource

    sim_cfg, days = mesh_train_sim()
    spec = dataclasses.replace(
        feed_spec(), ordered=True, batch_size=MESH_TRAIN_FEED_BATCH,
        source=SimSource(min_rows=MESH_TRAIN_STEPS * MESH_TRAIN_FEED_BATCH))
    out["dlrm-uih|train_batch"] = mesh_train_cell(
        pm, one, "dlrm-uih", "train_batch", {"batch": MESH_TRAIN_FEED_BATCH},
        smi, host, feed=(sim_cfg, days, spec))
    release("mesh_train dlrm-uih|train_batch")
    dens = out["dlrm-uih|train_batch"]["launches"]["fused_densify"]
    require(all(n > 0 for n in dens),
            f"mesh_train: fused_densify launches a rank {dens}: the placed "
            f"feed did not densify in every rank")
    for arch, shape, reduced in MESH_TRAIN_CELLS:
        if arch in MESH_TRAIN_F64:
            out[f"{arch}|{shape}|float32"] = mesh_train_cell(
                pm, one, arch, shape, reduced, smi, host, held=False)
            release(f"mesh_train {arch}|{shape} float32")
            out[f"{arch}|{shape}"] = mesh_train_cell(
                pm, one, arch, shape, reduced, smi, host,
                dtype=torch.float64)
        else:
            out[f"{arch}|{shape}"] = mesh_train_cell(pm, one, arch, shape,
                                                     reduced, smi, host)
        release(f"mesh_train {arch}|{shape}")


# ---------------------------------------------------------------------------
# phase 5: the model on the card agrees with the CPU on a small input
# ---------------------------------------------------------------------------

def smoke_batch(name: str, cfg, rng, b: int) -> dict:
    """A model-input batch for SMOKE tenant ``name`` from a numpy ``rng``,
    with right-aligned histories whose row 0 is all masked."""
    import numpy as np

    label = (rng.random(b) < 0.3).astype(np.float32)
    if name == "dcn-v2":
        return {"sparse_ids": rng.integers(0, cfg.field_vocab,
                                           (b, cfg.n_sparse)),
                "dense": rng.random((b, cfg.n_dense)).astype(np.float32),
                "label": label}
    s = cfg.seq_len
    lens = rng.integers(0, s + 1, b)
    lens[0] = 0
    mask = np.arange(s)[None, :] >= (s - lens)[:, None]
    batch = {"uih_item_id": rng.integers(0, cfg.item_vocab, (b, s)),
             "uih_mask": mask,
             "cand_item_id": rng.integers(0, cfg.item_vocab, b),
             "label": label}
    if name == "dien":
        batch["uih_category"] = rng.integers(0, cfg.cat_vocab, (b, s))
        batch["cand_category"] = rng.integers(0, cfg.cat_vocab, b)
    elif name == "bert4rec":
        batch["mask_pos"] = (rng.random((b, s)) < 0.3) & mask
        batch["neg_ids"] = rng.integers(0, cfg.item_vocab, 32)
    else:
        batch["uih_action_type"] = rng.integers(0, 16, (b, s))
        batch["sparse_ids"] = rng.integers(0, cfg.field_vocab,
                                           (b, cfg.n_sparse))
        batch["dense"] = rng.random((b, cfg.n_dense)).astype(np.float32)
    return batch


def model_check_phase():
    """Each SMOKE model's forward (and each new tenant's loss) on the card
    against the CPU, float32, from the same parameters and batch."""
    import numpy as np
    import torch

    from repro_torch.configs import bert4rec, dcn_v2, dien, dlrm_uih
    from repro_torch.models import recsys as R
    from repro_torch.tree import tree_map

    # float32 products in full precision on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = {
        "dlrm-uih": (dlrm_uih.SMOKE, R.init_dlrm_uih, R.dlrm_uih_forward,
                     None),
        "dcn-v2": (dcn_v2.SMOKE, R.init_dcn_v2, R.dcn_v2_forward,
                   R.dcn_v2_loss),
        "dien": (dien.SMOKE, R.init_dien, R.dien_forward, R.dien_loss),
        "bert4rec": (bert4rec.SMOKE, R.init_bert4rec, R.bert4rec_forward,
                     R.bert4rec_loss),
    }
    rng = np.random.default_rng(SEED)
    b = 8
    for name, (cfg, init, forward, loss) in models.items():
        batch = smoke_batch(name, cfg, rng, b)
        cpu = init(cfg, seed=SEED, device="cpu")
        card = tree_map(lambda t: t.detach().to(DEVICE), cpu)
        on_cpu = {k: torch.from_numpy(v) for k, v in batch.items()}
        on_card = {k: v.to(DEVICE) for k, v in on_cpu.items()}
        errs = []
        for fn, shape in ((forward, (b,)), (loss, ())):
            if fn is None:
                continue
            want = fn(cpu, on_cpu, cfg).detach()
            got = fn(card, on_card, cfg).detach()
            err = float((got.cpu() - want).abs().max())
            require(got.shape == shape and bool(torch.isfinite(got).all())
                    and torch.allclose(got.cpu(), want, rtol=1e-4,
                                       atol=1e-5),
                    f"SMOKE {name} {fn.__name__} on the card differs from "
                    f"the CPU: {err}")
            errs.append(f"{fn.__name__} {err:.3e}")
        say("model", f"SMOKE {name} on the card == CPU float32 within rtol "
                     f"1e-4, atol 1e-5 (max abs diff: {', '.join(errs)})")
    zoo_check(rng)


def zoo_check(rng) -> None:
    """Each zoo SMOKE config: the same parameters on the CPU and on the
    card, the loss and the prefill logits (LMs) or the forward and the loss
    (MeshGraphNet) compared, float32 at rtol 1e-4, atol 1e-5."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import gnn as G
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    def on(dev, arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    for arch in (*ZOO_LMS, "meshgraphnet"):
        cfg = get_arch(arch).smoke
        if arch == "meshgraphnet":
            n, e = 40, 160
            arrays = [rng.standard_normal((n, cfg.d_node_in)).astype("f4"),
                      rng.standard_normal((e, cfg.d_edge_in)).astype("f4"),
                      rng.integers(0, n, e), rng.integers(0, n, e),
                      rng.standard_normal((n, cfg.d_out)).astype("f4")]
            fns = {"forward": lambda p, a: G.forward(p, *a[:4], cfg),
                   "loss_fn": lambda p, a: G.loss_fn(p, *a, cfg)}
            init = G.init
        else:
            arrays = [rng.integers(0, cfg.vocab, (2, 32)),
                      rng.integers(0, cfg.vocab, (2, 32))]
            fns = {"loss_fn": lambda p, a: T.loss_fn(p, *a, cfg),
                   "prefill": lambda p, a: T.prefill(p, a[0], cfg)[0]}
            init = T.init
        cpu = init(cfg, seed=SEED, device="cpu")
        card = tree_map(lambda t: t.detach().to(DEVICE), cpu)
        errs = []
        for name, fn in fns.items():
            want = fn(cpu, on("cpu", arrays)).detach()
            got = fn(card, on(DEVICE, arrays)).detach()
            err = float((got.cpu() - want).abs().max())
            require(got.shape == want.shape
                    and bool(torch.isfinite(got).all())
                    and torch.allclose(got.cpu(), want, rtol=1e-4,
                                       atol=1e-5),
                    f"SMOKE {arch} {name} on the card differs from the CPU: "
                    f"{err}")
            errs.append(f"{name} {err:.3e}")
        say("model", f"SMOKE {arch} on the card == CPU float32 within rtol "
                     f"1e-4, atol 1e-5 (max abs diff: {', '.join(errs)})")


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


def release(what: str) -> None:
    """Hand a finished phase's device memory back before the next one
    (the cuBLAS workspaces too: one a thread that ran a product, 32 MiB
    each on this card, 1 GiB for the ``mesh`` phase's rank threads)."""
    import torch

    gc.collect()
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):   # a CUDA build's
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    require(left < 2**30, f"{left} B still allocated after the {what}")
    say("release", f"{what} tensors released: {left} B still allocated")
    torch.cuda.reset_peak_memory_stats()


def build_kernels() -> None:
    """Build every kernel library at once: one nvcc a source, all started
    together (each ``lib()`` waits on its own subprocess)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.adamw import ops as aw
    from repro_torch.kernels.delta_decode import ops as dd
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.fused import ops
    from repro_torch.kernels.grouped_gemm import ops as gg
    from repro_torch.kernels.jagged import ops as jg

    def timed_build(lib):
        t0 = time.perf_counter()
        lib.lib()
        return time.perf_counter() - t0

    libs = (ops.LIBRARY, eb.LIBRARY, jg.LIBRARY, dd.LIBRARY, aw.LIBRARY,
            gg.LIBRARY)
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
    t0 = time.perf_counter()
    adamw = adamw_phase(smi)
    say("adamw", f"phase in {time.perf_counter() - t0:.3f} s ({smi})")
    t0 = time.perf_counter()
    grouped = grouped_gemm_phase(smi)
    release("grouped_gemm")
    grouped["launches"] = dropless_phase(smi)
    release("dropless layer")
    say("grouped_gemm", f"phase in {time.perf_counter() - t0:.3f} s ({smi})")
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
    densify["launches"], adamw["launches"] = main_path_phase(sim)
    # the training path's parameters, optimizer state and feed died with
    # main_path_phase; hand their memory back before the next phase's
    release("main path")
    t0 = time.perf_counter()
    tenants = tenants_phase(sim, jf)
    say("tenants", f"phase in {time.perf_counter() - t0:.3f} s ({smi})")
    densify["more"]["tenant_launches"] = {n: d["launches"]
                                          for n, d in tenants.items()}
    densify["more"]["tenant_shapes"] = tenants
    release("tenants")
    t0 = time.perf_counter()
    stream_phase(smi)
    say("stream", f"phase in {time.perf_counter() - t0:.3f} s ({smi})")
    release("stream phase")
    t0 = time.perf_counter()
    entry = entry_phase(smi)
    say("entry", f"phase in {time.perf_counter() - t0:.3f} s ({smi})")
    release("entry")
    t0 = time.perf_counter()
    densify["more"]["cells_feed_launches"] = cells_phase(sim, smi)
    say("cells", f"phase in {time.perf_counter() - t0:.3f} s ({smi})")
    release("cells")
    t0 = time.perf_counter()
    zoo_phase(smi)
    say("zoo", f"phase in {time.perf_counter() - t0:.3f} s ({smi})")
    t0 = time.perf_counter()
    mesh_phase(smi)
    say("mesh", f"phase in {time.perf_counter() - t0:.3f} s ({smi})")
    release("mesh")
    t0 = time.perf_counter()
    mesh_train = mesh_train_phase(smi)
    say("mesh_train", f"phase in {time.perf_counter() - t0:.3f} s ({smi})")
    release("mesh_train")
    densify["more"]["mesh_train_launches"] = {
        k: r["launches"]["fused_densify"] for k, r in mesh_train.items()}

    params = two_tower_params()
    table = params["item_table"].detach()
    bag = embedding_bag_phase(table)
    histories = serve_phase(sim, params)
    late = late_materialize_phase(histories, table)
    bag["launches"] = late["embedding_bag"]
    for e in (densify, bag, jagged, delta):
        e.setdefault("more", {})["entry_points"] = {
            f"benchmarks_torch.{b}": n[e["name"]] for b, n in entry.items()
            if n[e["name"]]}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")
    print(json.dumps({"kernels": [{**{k: e[k] for k in keys},
                                   **e.get("more", {})}
                                  for e in (densify, bag, jagged, delta,
                                            adamw, grouped)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
