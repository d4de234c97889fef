"""Inference-time snapshotting (paper §3.3, Fig. 3).

During ranking, the service fetches the mutable tier (recent events) and the
immutable tier (long-term history) to assemble the complete UIH for model
inference. Under versioned late materialization, the logged training example
persists only:

  * the **mutable** slice (small: events newer than the immutable watermark),
    physically snapshotted at T_request so no late-arriving event can
    contaminate it; and
  * O(1) **version metadata** for the immutable window (start_ts = lookback
    bound, end_ts = immutable watermark, seq_len, checksum, generation).

The Fat Row baseline snapshotter logs the complete merged UIH instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import events as ev
from repro_torch.core.versioning import TrainingExample, VersionMetadata, window_checksum
from repro_torch.storage.immutable_store import ScanRequest
from repro_torch.storage.protocol import StoreProtocol
from repro_torch.storage.mutable_store import MutableUIHStore


@dataclasses.dataclass
class SnapshotterConfig:
    lookback_ms: int = 365 * ev.MS_PER_DAY
    max_seq_len: int = 1 << 20          # union-dataset maximum requirement
    with_checksum: bool = True
    nonseq_bytes: int = 1024            # opaque non-sequence feature payload


class BaseSnapshotter:
    def __init__(
        self,
        mutable: MutableUIHStore,
        immutable: StoreProtocol,
        schema: ev.TraitSchema,
        cfg: Optional[SnapshotterConfig] = None,
    ):
        self.mutable = mutable
        self.immutable = immutable
        self.schema = schema
        self.cfg = cfg or SnapshotterConfig()
        self._next_request_id = 0

    def _fetch_both_tiers(self, user_id: int, request_ts: int):
        """The inference read path: assemble complete UIH at T_request.

        The whole fetch runs under a transient **generation lease** on the
        live generation: the per-feature-group scans and the watermark read
        all resolve the SAME generation even if compaction publishes a new one
        mid-fetch (otherwise the groups could straddle a flip and the logged
        checksum/seq_len would describe a window no generation ever held).
        The leased generation id is what the version metadata records.

        Edge: before the first compaction the lease lands on generation -1,
        which pins nothing (-1 means "live" to scans) — if the FIRST flip
        races the fetch, we refetch against the now-live generation.

        Retention-coupling caveat (§4.1.1): the mutable tier is read after
        the immutable scans; an eviction whose watermark has advanced past
        the leased generation's would silently drop the gap from BOTH the
        example and its reference (consistently — leak-free but lossy).
        Production orders eviction a full cycle behind consolidation; the
        simulator's compactions are either sequential with traffic or run
        with ``evict=False``."""
        start_ts = max(0, request_ts - self.cfg.lookback_ms)
        while True:
            with self.immutable.acquire_lease() as lease:
                gen = lease.generation
                watermark = self.immutable.watermark(user_id, generation=gen)
                end_ts = min(watermark, request_ts)
                reqs = [
                    ScanRequest(user_id=user_id, group=g, start_ts=start_ts,
                                end_ts=end_ts, generation=gen)
                    for g in self.schema.feature_groups
                ]
                parts = self.immutable.multi_range_scan(reqs)
            if gen >= 0 or self.immutable.generation < 0:
                break   # leased fetch was generation-consistent
        immutable_part: ev.EventBatch = {}
        n = None
        for p in parts:
            if n is None:
                n = ev.batch_len(p)
            else:
                assert ev.batch_len(p) == n, "feature groups straddled a flip"
            immutable_part.update(p)
        # mutable tier: strictly newer than the immutable watermark, <= T_request
        # — but never older than the lookback start. When the watermark trails
        # start_ts (a user returning after idling past the lookback window),
        # the immutable scan is empty and an unclamped (watermark, request_ts]
        # read would feed the model mutable events OLDER than the lookback
        # bound no active user's UIH can ever contain (read is exclusive-lo,
        # so start_ts - 1 keeps start_ts itself in-window).
        mutable_part = self.mutable.read(
            user_id, max(end_ts, start_ts - 1), request_ts)
        return immutable_part, mutable_part, start_ts, end_ts, gen

    def inference_uih(self, user_id: int, request_ts: int) -> ev.EventBatch:
        """Complete UIH as seen by the ranking model at T_request (ground truth
        for O2O-consistency checks)."""
        tiers = self._fetch_both_tiers(user_id, request_ts)
        return ev.concat_batches(tiers[:2]) or ev.empty_batch(self.schema)

    def snapshot_with_reference(
        self,
        user_id: int,
        request_ts: int,
        candidate: Dict[str, int],
        labels: Optional[Dict[str, float]] = None,
        label_ts: Optional[int] = None,
        labels_fn=None,
    ):
        """(training example, inference-time ground-truth UIH) from ONE
        two-tier fetch — the pair is consistent by construction, which is what
        makes consistency audits deterministic even when compaction runs
        concurrently with snapshotting (a second fetch could land on the
        other side of a generation flip).

        ``labels_fn(reference_uih) -> labels`` lets label synthesis that
        depends on the inference-time UIH reuse the SAME fetch instead of
        issuing its own (which could straddle a flip)."""
        tiers = self._fetch_both_tiers(user_id, request_ts)
        imm, mut = tiers[0], tiers[1]
        ref = ev.concat_batches([imm, mut]) or ev.empty_batch(self.schema)
        if labels_fn is not None:
            labels = labels_fn(ref)
        return self._build(user_id, request_ts, candidate, labels or {},
                           label_ts, tiers), ref

    def snapshot(
        self,
        user_id: int,
        request_ts: int,
        candidate: Dict[str, int],
        labels: Dict[str, float],
        label_ts: Optional[int] = None,
    ) -> TrainingExample:
        return self._build(user_id, request_ts, candidate, labels, label_ts,
                           self._fetch_both_tiers(user_id, request_ts))

    def _build(self, user_id, request_ts, candidate, labels, label_ts, tiers
               ) -> TrainingExample:
        raise NotImplementedError

    def _alloc_id(self) -> int:
        rid = self._next_request_id
        self._next_request_id += 1
        return rid

    def _context(self, request_id: int) -> bytes:
        """Deterministic stand-in for the non-sequence feature payload
        (identical across VLM and Fat Row snapshotters for fair accounting)."""
        import numpy as _np

        return _np.random.default_rng(request_id).bytes(self.cfg.nonseq_bytes)


class VLMSnapshotter(BaseSnapshotter):
    """Versioned late materialization: log mutable slice + version metadata."""

    def _build(self, user_id, request_ts, candidate, labels, label_ts, tiers
               ) -> TrainingExample:
        imm, mut, start_ts, end_ts, gen = tiers
        seq_len = ev.batch_len(imm)
        checksum = (
            window_checksum(imm) if (self.cfg.with_checksum and seq_len) else 0
        )
        return TrainingExample(
            request_id=self._alloc_id(),
            user_id=user_id,
            request_ts=request_ts,
            label_ts=label_ts if label_ts is not None else request_ts,
            candidate=dict(candidate),
            labels=dict(labels),
            mutable_uih=mut,
            context=self._context(self._next_request_id - 1),
            version=VersionMetadata(
                start_ts=start_ts,
                end_ts=end_ts,
                seq_len=seq_len,
                checksum=checksum,
                generation=gen,   # the generation the scan actually ran on
            ),
        )


class FatRowSnapshotter(BaseSnapshotter):
    """Industry-standard baseline: physically pre-materialize the full UIH."""

    def _build(self, user_id, request_ts, candidate, labels, label_ts, tiers
               ) -> TrainingExample:
        imm, mut = tiers[0], tiers[1]
        fat = ev.concat_batches([imm, mut]) or ev.empty_batch(self.schema)
        return TrainingExample(
            request_id=self._alloc_id(),
            user_id=user_id,
            request_ts=request_ts,
            label_ts=label_ts if label_ts is not None else request_ts,
            candidate=dict(candidate),
            labels=dict(labels),
            fat_uih=fat,
            context=self._context(self._next_request_id - 1),
        )
