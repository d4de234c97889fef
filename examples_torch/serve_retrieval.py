"""Serving driver on the PyTorch port: snapshot-consistent two-tower
retrieval over the live sim.

The online half of the O2O story, on the port's serving tier
(``repro_torch.serve``): a ``RetrievalServer`` coalesces concurrent requests
into latency-bounded micro-batches, materializes each user's UIH under a
transient generation lease (checksum validation ON), encodes with the
two-tower user tower on the device, and answers batched top-k against a
refreshable item-tower candidate index. Repeat users are served from the
per-user embedding cache.

Run:  PYTHONPATH=src python examples_torch/serve_retrieval.py
          [--requests 512] [--device cpu]

Port of ``examples/serve_retrieval.py``: the same flags, defaults, sim
seed, model and printed lines; ``--device`` is ``cuda`` unless the caller
asks for ``cpu`` (no fallback). The parameters are drawn from a torch
generator seeded 0 (not the reference's ``PRNGKey(0)`` numbers); ``main``
takes others, as the tests pass the reference's through
``repro_torch.interop``.
"""
import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.core import events as ev
from repro_torch.core.simulation import ProductionSim, SimConfig
from repro_torch.device import resolve_device
from repro_torch.models import recsys as R
from repro_torch.obs import Telemetry
from repro_torch.serve import RetrievalServer, ServeConfig

CORPUS = 4_096
SEQ_LEN = 24
USERS = 64

MODEL = R.TwoTowerConfig(name="serve", embed_dim=32, tower_mlp=(64, 32),
                         item_vocab=CORPUS, user_vocab=1_024,
                         uih_len=SEQ_LEN, compute_dtype=torch.float32)


def build_sim() -> ProductionSim:
    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=USERS, n_items=CORPUS, days=4,
                               events_per_user_day_mean=40.0, seed=1),
        stripe_len=32, requests_per_user_day=4, seed=1))
    sim.run_days(3, capture_reference=False)
    return sim


def request_mix(sim: ProductionSim, n: int):
    """(now, users): every request asks for the user's UIH as of NOW (the
    last logged request time), the logged user sequence replayed
    round-robin to ``n``."""
    now = max(e.request_ts for e in sim.examples)
    users = [e.user_id for e in
             (sim.examples * (n // len(sim.examples) + 1))[:n]]
    return now, users


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    return ap.parse_args(argv)


def main(argv=None, params=None) -> list:
    """Serve the mix; ``params`` (optional) replaces the seeded
    initialization. Returns the results in request order."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = MODEL
    if params is None:
        params = R.init_two_tower(cfg, seed=0, device=device)

    sim = build_sim()
    telemetry = Telemetry()
    server = RetrievalServer.from_sim(
        sim, params, cfg, telemetry=telemetry,
        cfg=ServeConfig(max_batch=64, max_delay_s=0.005,
                        lookback_ms=sim.cfg.lookback_ms), device=device)
    print(f"candidate index: {len(server.index)} items "
          f"(v{server.index.version})")

    # request mix: live traffic, issued from 8 concurrent caller threads
    # (the coalescer re-batches them; a user's second request finds their
    # embedding cached and skips scan+featurize+encode entirely)
    now, users = request_mix(sim, args.requests)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(
            lambda u: server.retrieve(u, now, k=10), users))
    dt = time.perf_counter() - t0
    server.close()

    st, cs = server.stats, server.cache.stats
    print(f"served {st.requests} requests in {dt:.2f}s -> "
          f"{st.requests/dt:.0f} QPS "
          f"({server.coalescer.stats.batches} micro-batches, "
          f"corpus={CORPUS})")
    print(f"cold path: {st.cold_requests}, embedding-cache hits: "
          f"{cs.hits} ({cs.hits / max(1, cs.lookups):.0%})")
    # StoreProtocol stats work for monolith AND sharded backends
    io = server.materializer.io_stats
    print(f"immutable-store scans: {io.requests}, "
          f"bytes: {io.bytes_scanned/1e6:.2f} MB")
    print(f"no leaked leases: {sim.immutable.leased_generations() == {}}")
    r = results[0]
    print(f"sample top-10 for request 0 (gen {r.generation}, "
          f"cached={r.cached}): {r.item_ids.tolist()}")
    return results


if __name__ == "__main__":
    main()
