"""Snapshot-consistent low-latency retrieval serving (DESIGN.md §14).

Port of ``repro.serve.server``. ``RetrievalServer`` is the inference half
of the paper's O2O story: the same versioned store that training
materializes from answers live top-k requests.

Request lifecycle (§14.1):

  1. callers ``submit()`` / ``retrieve()``; the ``RequestCoalescer`` forms
     latency-bounded micro-batches (deadline + max-batch);
  2. a serving worker takes ONE transient ``GenerationLease`` per micro-batch
     — every watermark read, embedding-cache probe and immutable scan in the
     batch resolves the SAME generation, so a request can never straddle a
     compaction flip (the snapshotter's consistency contract, reused verbatim
     including the first-flip retry and the ``StaleGeneration`` remediation
     path of the shared ``Materializer``);
  3. per user: resolve ``end_ts = min(watermark, request_ts)``, read the
     mutable slice ``(end_ts, request_ts]``, and probe the
     ``UserEmbeddingCache`` with the exact ``(generation, freshness)`` tag —
     a hit skips store scan + featurize + user-tower forward entirely;
  4. cache misses build synthetic VLM examples (version metadata pointing at
     the leased generation) and go through ``Materializer.materialize_batch``
     → ``featurize`` → the user tower on the device, padded to a fixed
     batch shape so results are byte-identical regardless of batch
     composition (which is what makes cache-on vs cache-off byte-identical);
  5. all embeddings (cached + fresh) are scored against the
     ``CandidateIndex`` in one batched ``top_k``; per-request ``k`` slices
     the shared ``k_max`` result.

Each worker thread runs on the server's device under its own
``torch.inference_mode()`` (grad mode is thread-local in PyTorch). numpy has
no bf16, so user embeddings travel and sit in the cache as float32 arrays,
which holds bf16 values exactly; ``CandidateIndex.top_k`` casts them back to
the compute dtype, so cached and fresh rows score identically.

The server works unchanged over the monolith and the sharded/replicated
store (anything satisfying ``StoreProtocol``): degraded-mode behavior —
failover, hedged reads, breaker-gated replicas, partial reissues — lives
below the protocol surface, and a batch that still fails (e.g. every replica
of a shard down) fails ONLY its own requests, releases its lease, and the
server keeps serving.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.materialize import Materializer, StaleGeneration
from repro_torch.core.projection import TenantProjection
from repro_torch.core.versioning import TrainingExample, VersionMetadata
from repro_torch.dpp.featurize import FeatureSpec, featurize
from repro_torch.models import recsys as R
from repro_torch.obs.clock import now_ns
from repro_torch.obs.spans import ItemSpan
from repro_torch.serve.cache import UserEmbeddingCache
from repro_torch.serve.coalescer import PendingRequest, RequestCoalescer
from repro_torch.serve.index import CandidateIndex

# request-latency buckets: serving sits in the 100us..1s range, far below
# the registry's training-step DEFAULT_BUCKETS
SERVE_LATENCY_BUCKETS = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.02,
                         0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


@dataclasses.dataclass
class ServeConfig:
    """Knobs of the serving tier (coalescing, caching, consistency)."""

    max_batch: int = 16          # micro-batch size cap (also the pad shape)
    max_delay_s: float = 0.002   # oldest queued request waits at most this
    n_workers: int = 1           # serving worker threads (share one cache)
    default_k: int = 10          # top-k when the request does not say
    cache_capacity: int = 2048   # user-embedding LRU entries (0 = disabled)
    lookback_ms: int = 365 * ev.MS_PER_DAY   # UIH lookback horizon
    validate_checksum: bool = True           # forwarded to the Materializer
    window_cache_size: int = 256             # Materializer cross-batch LRU
    span_capacity: int = 512     # per-batch serve spans retained
    topk_sample_every: int = 64  # emit a serve_topk_sample event every N
    #                              batches (0 = never); feeds the report CLI
    stale_retries: int = 2       # micro-batch retries on StaleGeneration


@dataclasses.dataclass
class ServeStats:
    requests: int = 0            # requests answered (ok or failed)
    batches: int = 0             # micro-batches processed
    cold_requests: int = 0       # full scan+featurize+encode path
    cached_requests: int = 0     # answered from the user-embedding cache
    failed_requests: int = 0     # requests completed exceptionally
    stale_batch_retries: int = 0 # micro-batches retried after StaleGeneration
    lease_flip_retries: int = 0  # gen<0 lease raced the first compaction
    padded_rows: int = 0         # encode rows spent on fixed-shape padding


@dataclasses.dataclass
class RetrievalResult:
    """One answered request: best-first candidates + provenance tags."""

    user_id: int
    request_ts: int
    item_ids: np.ndarray         # [k] int64
    scores: np.ndarray           # [k] float32
    generation: int              # immutable generation the answer resolved on
    index_version: int           # candidate-index version that scored it
    cached: bool                 # user embedding came from the cache


class RetrievalServer:
    """Coalescing, snapshot-consistent two-tower retrieval server."""

    def __init__(
        self,
        store,
        mutable,
        schema: ev.TraitSchema,
        params,
        model_cfg: R.TwoTowerConfig,
        projection: Optional[TenantProjection] = None,
        feature_spec: Optional[FeatureSpec] = None,
        cfg: Optional[ServeConfig] = None,
        telemetry=None,
        index: Optional[CandidateIndex] = None,
        device: Any = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # worker threads need an index for torch.cuda.set_device
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.store = store
        self.mutable = mutable
        self.schema = schema
        self.params = params
        self.model_cfg = model_cfg
        self.cfg = cfg or ServeConfig()
        self.telemetry = telemetry
        self.projection = projection or TenantProjection(
            "serve", seq_len=model_cfg.uih_len, feature_groups=("core",),
            traits_per_group={"core": ("timestamp", "item_id")})
        self.feature_spec = feature_spec or FeatureSpec(
            seq_len=model_cfg.uih_len, uih_traits=("item_id",))
        self.materializer = Materializer(
            store, schema,
            validate_checksum=self.cfg.validate_checksum,
            pin_generations=True,
            window_cache_size=self.cfg.window_cache_size)
        self.index = index or CandidateIndex(model_cfg, telemetry=telemetry,
                                             device=self.device)
        if self.index.version == 0:
            self.index.refresh(params)
        self.cache = (UserEmbeddingCache(self.cfg.cache_capacity)
                      if self.cfg.cache_capacity > 0 else None)
        self.coalescer = RequestCoalescer(
            max_batch=self.cfg.max_batch, max_delay_s=self.cfg.max_delay_s)
        self.stats = ServeStats()
        self.spans: deque = deque(maxlen=self.cfg.span_capacity)
        self._lock = threading.Lock()   # stats + request-id counter
        self._next_rid = 0
        self._lat_hist = None
        self._stage_ctr = None
        if telemetry is not None:
            self._lat_hist = telemetry.registry.histogram(
                "repro_serve_request_seconds",
                "retrieval request latency, submit to answer",
                buckets=SERVE_LATENCY_BUCKETS).labels()
            self._stage_ctr = telemetry.registry.counter(
                "repro_serve_stage_seconds_total",
                "serving worker seconds by pipeline stage",
                labels=("stage",))
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"serve-worker-{i}")
            for i in range(self.cfg.n_workers)
        ]
        self._closed = False
        for t in self._workers:
            t.start()

    # -- public API ----------------------------------------------------------
    @classmethod
    def from_sim(cls, sim, params, model_cfg: R.TwoTowerConfig,
                 cfg: Optional[ServeConfig] = None, telemetry=None,
                 **kw) -> "RetrievalServer":
        """Wire a server onto a ``ProductionSim``'s live tiers (monolith or
        sharded — whatever ``sim.immutable`` is); ``kw`` may name the
        ``index`` and the ``device``."""
        if cfg is None:
            cfg = ServeConfig(lookback_ms=sim.cfg.lookback_ms)
        return cls(sim.immutable, sim.mutable, sim.schema, params, model_cfg,
                   cfg=cfg, telemetry=telemetry, **kw)

    def submit(self, user_id: int, request_ts: int,
               k: Optional[int] = None) -> PendingRequest:
        if self._closed:
            raise RuntimeError("server is closed")
        return self.coalescer.submit(
            PendingRequest(user_id, k or self.cfg.default_k, request_ts))

    def retrieve(self, user_id: int, request_ts: int,
                 k: Optional[int] = None,
                 timeout: float = 30.0) -> RetrievalResult:
        return self.submit(user_id, request_ts, k).result(timeout)

    def close(self) -> None:
        """Drain queued requests, stop the workers, publish final telemetry.
        Leases are strictly per-micro-batch, so after close the server holds
        none (asserted by tests via ``store.leased_generations()``)."""
        if self._closed:
            return
        self._closed = True
        self.coalescer.close()
        for t in self._workers:
            t.join()
        self.publish_telemetry()

    def publish_telemetry(self) -> None:
        if self.telemetry is None:
            return
        self.telemetry.publish_stats(self.stats, "serve")
        self.telemetry.publish_stats(self.coalescer.stats, "serve_coalesce")
        if self.cache is not None:
            self.telemetry.publish_stats(self.cache.stats, "serve_embed_cache")
        self.telemetry.publish_stats(self.index.stats, "serve_index")
        self.telemetry.publish_stats(self.materializer.stats, "serve_mat")

    # -- worker --------------------------------------------------------------
    def _encode(self, uid: np.ndarray, ids: np.ndarray,
                mask: np.ndarray) -> np.ndarray:
        """The user tower on one fixed-shape padded batch, as float32."""
        def put(a):
            return torch.from_numpy(a).to(self.device)

        z = R.two_tower_user(self.params, put(uid), put(ids), put(mask),
                             self.model_cfg)
        return z.float().cpu().numpy()

    def _worker_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            self._serve_loop()

    def _serve_loop(self) -> None:
        while True:
            batch, flush = self.coalescer.next_batch()
            if batch is None:
                return
            try:
                self._process_batch(batch, flush)
            except BaseException as e:   # noqa: BLE001 — server must survive
                with self._lock:
                    self.stats.failed_requests += sum(
                        0 if p.done() else 1 for p in batch)
                    self.stats.requests += len(batch)
                    self.stats.batches += 1
                for p in batch:
                    p._fail(e)

    def _process_batch(self, batch: List[PendingRequest], flush: str) -> None:
        """One micro-batch, retried whole on ``StaleGeneration`` (the lease
        makes that unreachable in steady state — the retry is the remediation
        backstop the snapshotter contract requires)."""
        attempt = 0
        while True:
            try:
                self._serve_batch(batch, flush)
                return
            except StaleGeneration:
                attempt += 1
                with self._lock:
                    self.stats.stale_batch_retries += 1
                if attempt > self.cfg.stale_retries:
                    raise

    def _acquire_consistent_lease(self):
        """The snapshotter's first-flip contract: a lease on generation -1
        pins nothing, so if the FIRST compaction published while we grabbed
        it, re-acquire against the now-live generation."""
        while True:
            lease = self.store.acquire_lease()
            if lease.generation < 0 and self.store.generation >= 0:
                lease.release()
                with self._lock:
                    self.stats.lease_flip_retries += 1
                continue
            return lease

    def _serve_batch(self, batch: List[PendingRequest], flush: str) -> None:
        cfg = self.cfg
        t_start = now_ns() / 1e9
        n = len(batch)
        embs: List[Optional[np.ndarray]] = [None] * n
        cold_idx: List[int] = []
        cold_examples: List[TrainingExample] = []
        cold_fresh: Dict[int, tuple] = {}

        lease = self._acquire_consistent_lease()
        gen = lease.generation
        try:
            # probe: per user, resolve the two-tier boundary under the lease
            # and try the embedding cache with the exact state tag
            for i, p in enumerate(batch):
                start_ts = max(0, p.request_ts - cfg.lookback_ms)
                wm = self.store.watermark(p.user_id, generation=gen)
                end_ts = min(wm, p.request_ts)
                # O(1) freshness tag: (request window, mutable write-state
                # version) — a hit skips even the mutable merged-view read
                fresh = (start_ts, end_ts, p.request_ts,
                         self.mutable.version(p.user_id))
                if self.cache is not None:
                    hit, reason = self.cache.get(p.user_id, gen, fresh)
                    if hit is not None:
                        embs[i] = hit
                        continue
                    if reason != "miss" and self.telemetry is not None:
                        self.telemetry.events.emit(
                            "serve_cache_invalidation", user=p.user_id,
                            reason=reason, generation=gen)
                mut = self.mutable.read(
                    p.user_id, max(end_ts, start_ts - 1), p.request_ts)
                cold_idx.append(i)
                cold_fresh[i] = fresh
                cold_examples.append(TrainingExample(
                    request_id=self._alloc_rid(),
                    user_id=p.user_id,
                    request_ts=p.request_ts,
                    label_ts=p.request_ts,
                    candidate={},
                    labels={},
                    mutable_uih=mut,
                    version=VersionMetadata(
                        start_ts=start_ts, end_ts=end_ts, seq_len=0,
                        checksum=0, generation=gen),
                ))

            # cold path: scan -> featurize -> encode, all under the lease so
            # the pinned generation cannot be GC'd mid-materialization
            t_probe = now_ns() / 1e9
            t_scan = t_feat = t_encode = t_probe
            if cold_idx:
                uihs = self.materializer.materialize_batch(
                    cold_examples, self.projection)
                t_scan = now_ns() / 1e9
                feats = featurize(cold_examples, uihs, self.feature_spec)
                pad_to = max(cfg.max_batch, len(cold_idx))
                uid = _pad_rows(feats["user_id"], pad_to)
                ids = _pad_rows(feats["uih_item_id"], pad_to)
                mask = _pad_rows(feats["uih_mask"], pad_to)
                t_feat = now_ns() / 1e9
                fresh_embs = self._encode(uid, ids, mask)[:len(cold_idx)]
                t_encode = now_ns() / 1e9
                for j, i in enumerate(cold_idx):
                    embs[i] = fresh_embs[j]
                    if self.cache is not None:
                        self.cache.put(batch[i].user_id, gen,
                                       cold_fresh[i], fresh_embs[j])
                with self._lock:
                    self.stats.padded_rows += pad_to - len(cold_idx)
        finally:
            lease.release()

        # score: one batched top_k over cached + fresh embeddings (the lease
        # is no longer needed — the store is out of the picture)
        k_max = max(p.k for p in batch)
        pad_to = max(cfg.max_batch, n)
        user_mat = _pad_rows(np.stack(embs, axis=0), pad_to)
        item_ids, scores = self.index.top_k(user_mat, k_max)
        t_score = now_ns() / 1e9
        index_version = self.index.version

        now = time.monotonic()
        for i, p in enumerate(batch):
            p._resolve(RetrievalResult(
                user_id=p.user_id,
                request_ts=p.request_ts,
                item_ids=item_ids[i, :p.k],
                scores=scores[i, :p.k],
                generation=gen,
                index_version=index_version,
                cached=i not in cold_fresh,
            ))
            if self._lat_hist is not None:
                self._lat_hist.observe(now - p.enqueue_t)

        n_cold = len(cold_idx)
        with self._lock:
            self.stats.requests += n
            self.stats.batches += 1
            self.stats.cold_requests += n_cold
            self.stats.cached_requests += n - n_cold
            batch_seq = self.stats.batches
        self._record_span(batch_seq, flush, gen, n, n_cold, t_start,
                          t_probe, t_scan, t_feat, t_encode, t_score)
        if (self.telemetry is not None and cfg.topk_sample_every
                and batch_seq % cfg.topk_sample_every == 1):
            p = batch[0]
            self.telemetry.events.emit(
                "serve_topk_sample", user=p.user_id, k=p.k,
                generation=gen, index_version=index_version,
                items=[int(x) for x in item_ids[0, :p.k]],
                scores=[round(float(s), 5) for s in scores[0, :p.k]])

    def _record_span(self, seq, flush, gen, size, cold, t_start, t_probe,
                     t_scan, t_feat, t_encode, t_score) -> None:
        sp = ItemSpan(seq=seq, t_mint=t_start)
        sp.stage("scan", t_start, t_scan)       # lease + probes + materialize
        sp.stage("featurize", t_scan, t_feat)
        sp.stage("encode", t_feat, t_encode)
        sp.stage("score", t_encode, t_score)
        sp.meta.update(flush=flush, generation=gen, size=size, cold=cold)
        self.spans.append(sp.to_dict())
        if self._stage_ctr is not None:
            for stage in ("scan", "featurize", "encode", "score"):
                self._stage_ctr.labels(stage=stage).inc(sp.stage_s(stage))

    def _alloc_rid(self) -> int:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            return rid


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad axis 0 to ``rows`` (row-independent ops downstream make the
    padded rows inert — they exist to keep one shape per batch, so per-row
    results are independent of batch composition)."""
    if arr.shape[0] >= rows:
        return arr
    pad = np.zeros((rows - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)
