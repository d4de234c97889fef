"""Offloaded compaction (paper §4.1.2, §4.3).

A daily ETL pipeline rebuilds the *entire lookback window* for every user from
source-of-truth data, producing complete, chronologically ordered sequences cut
into fixed-length stripes per (user_id, feature_group), pre-sorted to match the
store topology, then bulk-loaded as a single-level generation.

Because each cycle regenerates the full window:
  * multi-stripe range scans stay purely sequential (all temporal stripes of a
    user are coalesced into one run);
  * right-to-delete compliance is enforced idempotently (scrub predicates are
    re-applied on every cycle — no retroactive patching);
  * schema evolution (new/deprecated SideInfo traits) is a single pipeline run,
    not a multi-day backfill.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import events as ev
from repro_torch.storage import columnar
from repro_torch.storage.immutable_store import ImmutableUIHStore, Stripe

# source-of-truth reader: (user_id, t_lo, t_hi) -> full-schema EventBatch
SourceFn = Callable[[int, int, int], ev.EventBatch]
# right-to-delete: EventBatch -> bool mask of events to KEEP
ScrubFn = Callable[[ev.EventBatch], np.ndarray]


@dataclasses.dataclass
class CompactionConfig:
    stripe_len: int = 256          # events per stripe (fixed-length subsequences)
    lookback_ms: int = 365 * ev.MS_PER_DAY
    compress: bool = False


@dataclasses.dataclass
class CompactionReport:
    generation: int
    users: int = 0
    events: int = 0
    scrubbed_events: int = 0
    stripes: int = 0
    output_bytes: int = 0
    watermark_ts: int = -1


def make_scrub(
    deleted_items: Iterable[int] = (),
    deleted_creators: Iterable[int] = (),
) -> ScrubFn:
    items = np.asarray(sorted(set(int(i) for i in deleted_items)), dtype=np.int64)
    creators = np.asarray(sorted(set(int(c) for c in deleted_creators)), dtype=np.int64)

    def scrub(batch: ev.EventBatch) -> np.ndarray:
        n = ev.batch_len(batch)
        keep = np.ones(n, dtype=bool)
        if items.size and "item_id" in batch:
            keep &= ~np.isin(batch["item_id"], items)
        if creators.size and "creator_id" in batch:
            keep &= ~np.isin(batch["creator_id"], creators)
        return keep

    return scrub


class CompactionPipeline:
    def __init__(
        self,
        schema: ev.TraitSchema,
        cfg: Optional[CompactionConfig] = None,
    ):
        self.schema = schema
        self.cfg = cfg or CompactionConfig()

    def _stripes_for_group(
        self, history: ev.EventBatch, group: str
    ) -> List[Stripe]:
        traits = self.schema.group_traits(group)
        cols = ev.project_traits(history, traits)
        n = ev.batch_len(cols)
        out: List[Stripe] = []
        for lo in range(0, n, self.cfg.stripe_len):
            hi = min(lo + self.cfg.stripe_len, n)
            piece = ev.slice_batch(cols, lo, hi)
            blob = columnar.encode_stripe(piece, self.schema, self.cfg.compress)
            out.append(
                Stripe(
                    start_ts=int(piece["timestamp"][0]),
                    end_ts=int(piece["timestamp"][-1]),
                    n_events=hi - lo,
                    blob=blob,
                )
            )
        return out

    def run(
        self,
        source: SourceFn,
        user_ids: Sequence[int],
        as_of_ts: int,
        store: ImmutableUIHStore,
        scrub: Optional[ScrubFn] = None,
        generation: Optional[int] = None,
    ) -> CompactionReport:
        """Rebuild the full lookback window as of ``as_of_ts`` and bulk-load it.

        ``as_of_ts`` becomes the immutable watermark: events with
        timestamp <= as_of_ts move to the immutable tier; the mutable tier may
        evict them afterwards (retention coupling, §4.1.1)."""
        gen = store.generation + 1 if generation is None else generation
        report = CompactionReport(generation=gen)
        tables: Dict[Tuple[int, str], List[Stripe]] = {}
        t_lo = max(0, as_of_ts - self.cfg.lookback_ms)
        for uid in user_ids:
            history = source(int(uid), t_lo, as_of_ts)
            n_raw = ev.batch_len(history)
            if n_raw == 0:
                continue
            ev.validate_batch(history)
            if scrub is not None:
                keep = scrub(history)
                history = ev.take_batch(history, np.nonzero(keep)[0])
                report.scrubbed_events += int(n_raw - ev.batch_len(history))
            if ev.batch_len(history) == 0:
                continue
            report.users += 1
            report.events += ev.batch_len(history)
            for group in self.schema.feature_groups:
                stripes = self._stripes_for_group(history, group)
                if stripes:
                    tables[(int(uid), group)] = stripes
                    report.stripes += len(stripes)
                    report.output_bytes += sum(len(s.blob) for s in stripes)
        store.bulk_load(tables, generation=gen)
        report.watermark_ts = as_of_ts
        return report
