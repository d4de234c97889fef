"""Serving-tier QPS + tail latency on the PyTorch port under three regimes
(DESIGN.md §14.6).

Port of ``benchmarks/bench_serve.py``: the same results, ``derived`` keys
and asserted invariants; the servers encode and score on ``device``
(``cuda`` unless the caller asks for ``cpu``), with parameters drawn from
a torch generator seeded as the reference seeds its keys. None of the four
kernels is on this path.

One request mix (live traffic: every request asks for a user's UIH as of
"now", user sequence replayed from the sim's logged requests so repeat users
dominate), served twice per regime — a COLD wave against an empty embedding
cache and a WARM wave of the identical mix — under:

  * ``serve_healthy``     — monolith store, nothing racing: baseline QPS,
                            p50/p99, and the warm/cold speedup the per-user
                            embedding cache buys (asserted >= 2x in full
                            mode; open-loop waves, so the wall measures
                            server throughput rather than caller-thread
                            scheduling, and p50/p99 include queueing);
  * ``serve_churn``       — a compaction thread flips generations the whole
                            time: every flip invalidates cached embeddings
                            and forces re-materialization, yet snapshot
                            consistency must hold (zero failed requests, no
                            ``StaleGeneration`` escapes, no leaked leases);
  * ``serve_faults``      — the 4-node r=2 sharded/replicated tier with a
                            seeded ``FaultPlan`` of ``node_flap`` +
                            ``node_slow``: flaps are absorbed by replica
                            failover, slow nodes stretch the tail, and the
                            same zero-escape invariants are asserted.

Every wave also asserts the warm results byte-identical to the cold wave's
(healthy regime) — the cache is a latency optimization, never a staleness
trade.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
import torch

from benchmarks_torch.common import BenchResult
from repro_torch.core import events as ev
from repro_torch.core.simulation import ProductionSim, SimConfig
from repro_torch.models import recsys as R
from repro_torch.obs import Telemetry
from repro_torch.serve import RetrievalServer, ServeConfig
from repro_torch.testing import FaultPlan, FaultSpec, wrap_sim

CORPUS = 2_048
TOP_K = 10
CALLERS = 64

# remote-I/O latency for the disaggregated regime: light enough for a quick
# run, heavy enough that a node_slow x8 stretch is visible in the tail
SERVE_LATENCY = (lambda seeks, nbytes, fanout:
                 3e-4 * seeks + nbytes / 2e8)


def _model_cfg(quick: bool) -> R.TwoTowerConfig:
    return R.TwoTowerConfig(
        name="bench-serve", embed_dim=32, tower_mlp=(64, 32),
        item_vocab=CORPUS, user_vocab=4_096,
        uih_len=16 if quick else 128, compute_dtype=torch.float32)


def _sim(quick: bool, nodes: int = 0, replication: int = 1,
         hedge: float = 0.0, events_mean: float = 0.0,
         users: int = 0) -> ProductionSim:
    # full mode targets the paper's regime: dense histories so the cold
    # path's scan+featurize+encode is the dominant cost a cache can save.
    # ``events_mean``/``users`` override that shape (the churn regime needs
    # cheap compaction cycles so generation flips actually race the waves).
    d_users, days = (8, 2) if quick else (32, 4)
    users = users or d_users
    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(
            n_users=users, n_items=CORPUS, days=days + 2,
            events_per_user_day_mean=(
                events_mean or (20.0 if quick else 400.0)), seed=7),
        stripe_len=16, requests_per_user_day=3, mode="vlm", seed=7,
        n_store_nodes=nodes, replication_factor=replication,
        hedge_quantile=hedge))
    sim.run_days(days, capture_reference=False)
    return sim


def _mix(sim, n_requests: int) -> Tuple[int, List[int]]:
    """(now, user sequence): the logged request users replayed round-robin,
    all asking for their UIH as of the last logged request time."""
    now = max(e.request_ts for e in sim.examples)
    seq = [e.user_id for e in sim.examples]
    users = (seq * (n_requests // len(seq) + 1))[:n_requests]
    return now, users


def _issue(server: RetrievalServer, now: int, users: List[int]):
    """Fire the mix from CALLERS concurrent threads; returns (results,
    wall_s, per-request latencies)."""
    lats: List[float] = []
    lock = threading.Lock()

    def one(u: int):
        t0 = time.perf_counter()
        r = server.retrieve(u, now, k=TOP_K, timeout=60.0)
        dt = time.perf_counter() - t0
        with lock:
            lats.append(dt)
        return r

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=CALLERS) as pool:
        results = list(pool.map(one, users))
    return results, time.perf_counter() - t0, lats


def _issue_open(server: RetrievalServer, now: int, users: List[int]):
    """Open-loop throughput wave: enqueue the WHOLE mix up front, then drain.
    The coalescer sees genuinely full batches and the wall clock measures
    server-side throughput instead of caller-thread scheduling jitter (the
    closed-loop ``_issue`` wall is dominated by Python thread wakeups)."""
    t0 = time.perf_counter()
    pendings = [server.submit(u, now, k=TOP_K) for u in users]
    results = [p.result(timeout=60.0) for p in pendings]
    wall = time.perf_counter() - t0
    lats = [p.done_t - p.enqueue_t for p in pendings]
    return results, wall, lats


def _warmup(server: RetrievalServer, now: int) -> None:
    """Make the first calls (user tower at the pad shape, top-k scorer:
    the card's library set-up) outside the timed waves, then reset the
    caches so the cold wave is cold."""
    server.retrieve(0, now, k=TOP_K, timeout=60.0)
    if server.cache is not None:
        server.cache.clear()
    server.materializer._window_cache.clear()


def _assert_consistent(server: RetrievalServer, store) -> None:
    st = server.stats
    assert st.failed_requests == 0, f"requests failed: {st}"
    assert server.materializer.stats.stale_failures == 0, (
        "StaleGeneration escaped remediation")
    leaked = store.leased_generations()
    assert leaked == {}, f"leaked leases after shutdown: {leaked}"


def _result(name: str, wall_cold: float, wall_warm: float, n: int,
            lats: List[float], server: RetrievalServer,
            extra=None) -> BenchResult:
    st, cs = server.stats, server.cache.stats
    lat = np.asarray(lats)
    derived = {
        "qps_cold": round(n / wall_cold, 1),
        "qps_warm": round(n / wall_warm, 1),
        "warm_speedup": round(wall_cold / wall_warm, 2),
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
        "cold_requests": st.cold_requests,
        "cache_hit_rate": round(cs.hits / max(1, cs.lookups), 3),
        "batches": server.coalescer.stats.batches,
    }
    derived.update(extra or {})
    return BenchResult(name, wall_cold / n * 1e6, derived)


def _run_healthy(quick: bool, n_req: int, telemetry,
                 device) -> BenchResult:
    """Cold path (cache disabled) vs warm cache on the SAME mix: the two
    servers share the store, model and params, so cache-on must be
    byte-identical to cache-off — and >= 2x faster once warm."""
    sim = _sim(quick)
    cfg_m = _model_cfg(quick)
    params = R.init_two_tower(cfg_m, seed=0, device=device)
    now, users = _mix(sim, n_req)
    reps = 1 if quick else 2   # best-of-N walls: de-noise thread scheduling

    # batch size matches the caller count: in the closed loop the warm wave
    # then flushes mostly-full size batches, so its wall is ~n_req/CALLERS
    # top-k dispatches instead of dozens of ragged deadline flushes
    cold_srv = RetrievalServer.from_sim(
        sim, params, cfg_m, telemetry=telemetry,
        cfg=ServeConfig(max_batch=CALLERS, max_delay_s=0.002, cache_capacity=0,
                        window_cache_size=0,   # true cold path: every request scans
                        lookback_ms=sim.cfg.lookback_ms), device=device)
    _warmup(cold_srv, now)
    wall_cold, lats = float("inf"), []
    for _ in range(reps):      # cache-free server: every wave is fully cold
        cold, w, ls = _issue_open(cold_srv, now, users)
        wall_cold, lats = min(wall_cold, w), lats + ls
    cold_srv.close()
    _assert_consistent(cold_srv, sim.immutable)

    warm_srv = RetrievalServer.from_sim(
        sim, params, cfg_m, telemetry=telemetry,
        cfg=ServeConfig(max_batch=CALLERS, max_delay_s=0.002,
                        lookback_ms=sim.cfg.lookback_ms), device=device)
    _warmup(warm_srv, now)
    _issue_open(warm_srv, now, users)      # populate the embedding cache
    wall_warm, lats_w = float("inf"), []
    for _ in range(reps):
        warm, w, ls = _issue_open(warm_srv, now, users)
        wall_warm, lats_w = min(wall_warm, w), lats_w + ls
    warm_srv.close()
    _assert_consistent(warm_srv, sim.immutable)
    # the store's scan and hedge threads must not run on into the next
    # benchmark of this process
    sim.immutable.close()

    identical = all(
        np.array_equal(a.item_ids, b.item_ids)
        and np.array_equal(a.scores, b.scores)
        for a, b in zip(cold, warm))
    assert identical, "cache-on results diverged from the cache-off path"
    if not quick:
        assert wall_cold / wall_warm >= 2.0, (
            f"warm-cache throughput only {wall_cold / wall_warm:.2f}x the "
            f"cold path (acceptance floor is 2x)")
    return _result("serve/healthy", wall_cold, wall_warm, n_req,
                   lats + lats_w, warm_srv, {
                       "byte_identical": identical,
                       "qps_cold_path": round(n_req / wall_cold, 1)})


def _run_churn(quick: bool, n_req: int, telemetry,
               device) -> BenchResult:
    sim = _sim(quick, events_mean=20.0, users=8)
    cfg_m = _model_cfg(quick)
    params = R.init_two_tower(cfg_m, seed=1, device=device)
    server = RetrievalServer.from_sim(
        sim, params, cfg_m, telemetry=telemetry,
        cfg=ServeConfig(max_batch=32, max_delay_s=0.001,
                        lookback_ms=sim.cfg.lookback_ms), device=device)
    now, users = _mix(sim, n_req)
    _warmup(server, now)
    gen0 = sim.immutable.generation
    stop = threading.Event()
    flips = [0]

    def churn():
        while not stop.is_set():
            sim.run_compaction(now, evict=False)   # generation churn
            flips[0] += 1
            time.sleep(0.002)

    th = threading.Thread(target=churn, daemon=True)
    th.start()
    try:
        _, wall_cold, lats = _issue(server, now, users)
        _, wall_warm, lats_w = _issue(server, now, users)
    finally:
        stop.set()
        th.join()
    server.close()
    _assert_consistent(server, sim.immutable)
    assert sim.immutable.generation > gen0 and flips[0] >= 1, (
        "churn thread never flipped a generation")
    # the store's scan and hedge threads must not run on into the next
    # benchmark of this process
    sim.immutable.close()
    return _result("serve/compaction_churn", wall_cold, wall_warm, n_req,
                   lats + lats_w, server, {
                       "generation_flips": flips[0],
                       "cache_invalidations":
                           server.cache.stats.invalidated_generation,
                       "pinned_windows":
                           server.materializer.stats.pinned_windows,
                   })


def _run_faults(quick: bool, n_req: int, telemetry,
                device) -> BenchResult:
    sim = _sim(quick, nodes=4, replication=2, hedge=0.9)
    cfg_m = _model_cfg(quick)
    params = R.init_two_tower(cfg_m, seed=2, device=device)
    if quick:
        # a tiny run has too few scan ticks for seeded rates to reliably
        # land: pin one flap + one slow early so both paths still execute
        plan = FaultPlan([
            FaultSpec("node_flap", at=1, node=1, duration=2),
            FaultSpec("node_slow", at=3, node=2, duration=2, factor=8.0),
        ])
    else:
        plan = FaultPlan.seeded(
            11, {"node_flap": 0.10, "node_slow": 0.10}, horizon=48)
    fsim = wrap_sim(sim, plan)
    sim.immutable.latency_model = SERVE_LATENCY
    server = RetrievalServer.from_sim(
        fsim, params, cfg_m, telemetry=telemetry,
        cfg=ServeConfig(max_batch=32, max_delay_s=0.001,
                        lookback_ms=sim.cfg.lookback_ms), device=device)
    now, users = _mix(sim, n_req)
    _warmup(server, now)
    _, wall_cold, lats = _issue(server, now, users)
    _, wall_warm, lats_w = _issue(server, now, users)
    server.close()
    settled = fsim.immutable.settle_node_state()
    sim.immutable.latency_model = None
    _assert_consistent(server, sim.immutable)
    assert plan.n_fired >= 1, "fault plan never fired"
    io = sim.immutable.stats
    # the store's scan and hedge threads must not run on into the next
    # benchmark of this process
    sim.immutable.close()
    return _result("serve/sharded_faults", wall_cold, wall_warm, n_req,
                   lats + lats_w, server, {
                       "faults_fired": plan.n_fired,
                       "faults_settled": settled,
                       "failovers": io.failovers,
                       "hedged_reads": io.hedged_reads,
                       "degraded_scans": io.degraded_scans,
                   })


def run(quick: bool = False, telemetry=None, device: str = "cuda"):
    n_req = 96 if quick else 512
    tel = telemetry if telemetry is not None else Telemetry()
    dev = torch.device(device)
    return [
        _run_healthy(quick, n_req, tel, dev),
        _run_churn(quick, n_req, tel, dev),
        _run_faults(quick, n_req, tel, dev),
    ]


if __name__ == "__main__":
    for r in run(quick="--quick" in __import__("sys").argv):
        print(r.csv())
