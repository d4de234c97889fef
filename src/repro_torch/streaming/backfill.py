"""Batch→stream catch-up handoff (paper §3.2).

A trainer that starts (or restarts) behind the live edge first **replays
warehouse hours** — the batch tier, user-bucketed, cheap sequential reads —
then **flips to live stream consumption**, with an exactly-once guarantee at
the flip:

  * ``request_id``s are allocated monotonically in request-arrival order, and
    warehouse hours partition that order, so the largest replayed id is a
    **watermark**: every id <= watermark has been trained from the warehouse;
  * the live phase drops stream examples with ``request_id <= watermark``
    (they are the same examples, republished on the other leg of the
    bifurcated pipeline) and releases their generation leases — through
    ``on_duplicate`` when the owner must hold a lease back (a
    ``StreamingSession`` does while the replayed copy is still being
    materialized, see ``streaming.session``);
  * everything above the watermark is trained exactly once, from the stream.

The replayed hour range is captured at **construction time** and must be
sealed (no concurrent ingestion into those hours): construct the coordinator
while the warehouse head is a finished hour, then start live traffic. Hours
inside the range with no data read as empty — the sweep is contiguous and
gap-tolerant.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence

from repro_torch.core.versioning import TrainingExample
from repro_torch.storage.stream import Warehouse
from repro_torch.streaming.source import StreamingSource


@dataclasses.dataclass(frozen=True)
class ReplayFilter:
    """One crash epoch's exactly-once exclusion (crash-safe resume, §10).

    A killed trainer's ``Feed.checkpoint`` records, per run, what was already
    trained: a PREFIX of the warehouse replay order (``skip_rows`` — rows
    trained while backfilling) plus a request-id INTERVAL ``(drop_lo,
    drop_hi]`` (rows trained from the live stream after the flip; live ids
    arrive monotonically, so the trained set is exactly an id interval above
    that epoch's replay watermark). On restart the coordinator re-replays the
    (now longer) warehouse sweep with the filter chain applied in crash-epoch
    order: each filter sees only rows that survived the earlier epochs'
    filters, so repeated kill/resume cycles compose. Rows in an epoch's old
    replay range have ids <= that epoch's watermark ``drop_lo`` and can never
    be interval-dropped by it — prefix counting stays exact."""

    skip_rows: int = 0
    drop_lo: int = -1     # exclusive lower bound of the trained-live interval
    drop_hi: int = -1     # inclusive upper bound; hi < lo disables

    def to_state(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state(cls, d: dict) -> "ReplayFilter":
        return cls(skip_rows=int(d.get("skip_rows", 0)),
                   drop_lo=int(d.get("drop_lo", -1)),
                   drop_hi=int(d.get("drop_hi", -1)))


@dataclasses.dataclass
class BackfillStats:
    hours_replayed: int = 0
    empty_hours: int = 0
    warehouse_examples: int = 0
    stream_examples: int = 0
    duplicates_skipped: int = 0   # stream copies of warehouse-trained examples
    resume_skipped: int = 0       # rows excluded by resume ReplayFilters
    watermark: int = -1           # largest request_id trained from the warehouse
    flipped: bool = False         # reached the live phase


class BackfillCoordinator:
    """Replay ``warehouse`` hours up to the (sealed) head, then flip to live
    consumption from ``source`` — one unified micro-batch iterator a
    ``DPPWorkerPool`` can drain via ``start_stream``."""

    def __init__(
        self,
        warehouse: Warehouse,
        source: StreamingSource,
        micro_batch: int = 32,
        start_hour: Optional[int] = None,
        end_hour: Optional[int] = None,
        resume_filters: Sequence[ReplayFilter] = (),
        on_duplicate: Optional[Callable[[TrainingExample], None]] = None,
    ):
        self.warehouse = warehouse
        self.source = source
        self.micro_batch = micro_batch
        hours = warehouse.hours()
        # the replay range is FROZEN here: [start_hour, end_hour] must be
        # sealed before live traffic starts, or the watermark under-covers
        self.start_hour = start_hour if start_hour is not None else (
            hours[0] if hours else 0)
        self.end_hour = end_hour if end_hour is not None else (
            hours[-1] if hours else self.start_hour - 1)
        # crash-safe resume: one filter per prior kill, oldest first. Mutable
        # per-filter prefix counters live here, not in the frozen filters.
        self._filters: List[List] = [[f, 0] for f in resume_filters]
        # what to do with a live copy of an already-replayed example: by
        # default forget it at once (lease and freshness clock)
        self.on_duplicate = on_duplicate or source.discard
        self.stats = BackfillStats()
        # optional repro_torch.obs.Telemetry (control-plane events)
        self.telemetry = None

    # -- resume filter chain ---------------------------------------------------
    def _replay_drops(self, exm: TrainingExample) -> bool:
        """True iff a prior crash epoch already trained this replay row. Each
        filter only sees rows that survived the earlier epochs (the chain
        reproduces each epoch's own input sequence)."""
        for entry in self._filters:
            f: ReplayFilter = entry[0]
            if f.drop_lo < exm.request_id <= f.drop_hi:
                return True        # trained from the live stream that epoch
            if entry[1] < f.skip_rows:
                entry[1] += 1
                return True        # trained during that epoch's backfill
        return False

    def _interval_drops(self, request_id: int) -> bool:
        """Live-phase belt-and-braces: a prior epoch's live-trained id that
        somehow reappears on the stream must still be dropped exactly-once."""
        return any(f.drop_lo < request_id <= f.drop_hi
                   for f, _ in self._filters)

    def micro_batches(self) -> Iterator[List[TrainingExample]]:
        st = self.stats
        # -- phase 1: warehouse replay (contiguous, gap-tolerant hour sweep) --
        buf: List[TrainingExample] = []
        for hour in range(self.start_hour, self.end_hour + 1):
            empty = True
            for bucket in self.warehouse.iter_bucketed(hour):
                for exm in bucket:
                    empty = False
                    # the watermark covers SKIPPED rows too: they trained in a
                    # prior epoch, so their stream copies must still dedupe
                    if exm.request_id > st.watermark:
                        st.watermark = exm.request_id
                    if self._replay_drops(exm):
                        st.resume_skipped += 1
                        continue
                    st.warehouse_examples += 1
                    buf.append(exm)
                    if len(buf) >= self.micro_batch:
                        yield buf
                        buf = []
            st.hours_replayed += 1
            if empty:
                st.empty_hours += 1
        if buf:
            yield buf
        st.flipped = True
        if self.telemetry is not None:
            self.telemetry.events.emit(
                "backfill_flip", watermark=st.watermark,
                hours_replayed=st.hours_replayed,
                warehouse_examples=st.warehouse_examples)
        # -- phase 2: live stream, exactly-once across the flip ---------------
        for mb in self.source.micro_batches():
            keep: List[TrainingExample] = []
            for exm in mb:
                if (exm.request_id <= st.watermark
                        or self._interval_drops(exm.request_id)):
                    st.duplicates_skipped += 1
                    self.on_duplicate(exm)     # release its lease; it trains
                    continue                   # from the warehouse
                st.stream_examples += 1
                keep.append(exm)
            if keep:
                yield keep
