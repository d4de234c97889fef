"""UIH event model: trait schema, feature groups, and a synthetic event-stream generator.

A user's interaction history (UIH) is a *columnar* batch of events: a dict of
equal-length numpy arrays ("traits"), always sorted by ``timestamp`` ascending.
Events are append-only and immutable once written (the structural invariant the
paper's protocol exploits, §3.1).

Traits carry density/encoding hints so the trait-aware columnar codec (§4.1.2)
can pick delta / bitmap / dictionary / bit-width encodings per column.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Trait schema
# ---------------------------------------------------------------------------

# Encoding classes understood by repro.storage.columnar
DENSE_MONOTONE = "dense_monotone"   # e.g. timestamps: delta + bit-width packing
DENSE_ID = "dense_id"               # e.g. item ids: bit-width packing
SPARSE_FLAG = "sparse_flag"         # e.g. like/share: presence bitmap
CATEGORICAL = "categorical"         # e.g. event type: dictionary + bit-width
DENSE_VALUE = "dense_value"         # e.g. watch time: bit-width packing


@dataclasses.dataclass(frozen=True)
class TraitSpec:
    name: str
    dtype: np.dtype
    encoding: str  # one of the classes above

    def empty(self, n: int = 0) -> np.ndarray:
        return np.zeros(n, dtype=self.dtype)


@dataclasses.dataclass(frozen=True)
class TraitSchema:
    """Full trait schema + feature-group partition of the traits.

    ``feature_groups`` maps group name -> tuple of trait names. ``timestamp``
    is implicitly a member of every group (it is the versioning key).
    """

    traits: Tuple[TraitSpec, ...]
    feature_groups: Mapping[str, Tuple[str, ...]]

    def __post_init__(self):
        names = {t.name for t in self.traits}
        assert "timestamp" in names, "schema must include a timestamp trait"
        for g, cols in self.feature_groups.items():
            missing = set(cols) - names
            assert not missing, f"group {g} references unknown traits {missing}"

    @property
    def trait_names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.traits)

    def spec(self, name: str) -> TraitSpec:
        for t in self.traits:
            if t.name == name:
                return t
        raise KeyError(name)

    def group_traits(self, group: str) -> Tuple[str, ...]:
        cols = self.feature_groups[group]
        if "timestamp" in cols:
            return cols
        return ("timestamp",) + tuple(cols)

    def with_traits(
        self,
        add: Sequence[TraitSpec] = (),
        drop: Sequence[str] = (),
        feature_groups: Optional[Mapping[str, Tuple[str, ...]]] = None,
    ) -> "TraitSchema":
        """Schema evolution (§4.3): add new SideInfo traits / deprecate old ones."""
        drop_set = set(drop)
        assert "timestamp" not in drop_set
        kept = tuple(t for t in self.traits if t.name not in drop_set) + tuple(add)
        if feature_groups is None:
            kept_names = {t.name for t in kept}
            feature_groups = {
                g: tuple(c for c in cols if c in kept_names)
                for g, cols in self.feature_groups.items()
            }
        return TraitSchema(traits=kept, feature_groups=dict(feature_groups))


def default_schema() -> TraitSchema:
    """Production-flavoured schema: dense core traits, sparse engagement traits,
    dictionary-encodable SideInfo."""
    traits = (
        TraitSpec("timestamp", np.dtype(np.int64), DENSE_MONOTONE),
        TraitSpec("item_id", np.dtype(np.int64), DENSE_ID),
        TraitSpec("action_type", np.dtype(np.int32), CATEGORICAL),
        TraitSpec("surface", np.dtype(np.int32), CATEGORICAL),
        TraitSpec("watch_time_ms", np.dtype(np.int32), DENSE_VALUE),
        TraitSpec("like", np.dtype(np.int8), SPARSE_FLAG),
        TraitSpec("comment", np.dtype(np.int8), SPARSE_FLAG),
        TraitSpec("share", np.dtype(np.int8), SPARSE_FLAG),
        TraitSpec("category", np.dtype(np.int32), CATEGORICAL),
        TraitSpec("creator_id", np.dtype(np.int64), DENSE_ID),
    )
    groups = {
        "core": ("timestamp", "item_id", "action_type"),
        "engagement": ("like", "comment", "share", "watch_time_ms"),
        "sideinfo": ("category", "creator_id", "surface"),
    }
    return TraitSchema(traits=traits, feature_groups=groups)


# ---------------------------------------------------------------------------
# Columnar event batches
# ---------------------------------------------------------------------------

EventBatch = Dict[str, np.ndarray]  # trait name -> column, sorted by timestamp


def empty_batch(schema: TraitSchema, traits: Optional[Sequence[str]] = None) -> EventBatch:
    names = traits if traits is not None else schema.trait_names
    return {n: schema.spec(n).empty() for n in names}


def batch_len(batch: EventBatch) -> int:
    if not batch:
        return 0
    return len(next(iter(batch.values())))


def validate_batch(batch: EventBatch, schema: Optional[TraitSchema] = None) -> None:
    n = batch_len(batch)
    for k, v in batch.items():
        assert v.ndim == 1 and len(v) == n, f"trait {k} ragged: {len(v)} != {n}"
        if schema is not None:
            assert v.dtype == schema.spec(k).dtype, (k, v.dtype)
    ts = batch.get("timestamp")
    if ts is not None and len(ts) > 1:
        assert np.all(np.diff(ts) >= 0), "events must be time-ordered"


def concat_batches(batches: Sequence[EventBatch]) -> EventBatch:
    batches = [b for b in batches if batch_len(b) > 0]
    if not batches:
        return {}
    keys = batches[0].keys()
    return {k: np.concatenate([b[k] for b in batches]) for k in keys}


def slice_batch(batch: EventBatch, lo: int, hi: int) -> EventBatch:
    return {k: v[lo:hi] for k, v in batch.items()}


def take_batch(batch: EventBatch, idx: np.ndarray) -> EventBatch:
    return {k: v[idx] for k, v in batch.items()}


def time_slice(batch: EventBatch, t_lo: int, t_hi: int) -> EventBatch:
    """Events with t_lo <= timestamp <= t_hi (the temporal predicate of §3.1)."""
    ts = batch["timestamp"]
    lo = int(np.searchsorted(ts, t_lo, side="left"))
    hi = int(np.searchsorted(ts, t_hi, side="right"))
    return slice_batch(batch, lo, hi)


def project_traits(batch: EventBatch, traits: Sequence[str]) -> EventBatch:
    return {k: batch[k] for k in traits}


def tail_view(batch: EventBatch, max_events: int,
              traits: Optional[Sequence[str]] = None) -> EventBatch:
    """THE carve rule of the multi-dimensional projection (§4.1.2): keep the
    most recent ``max_events`` events (-1 = all), then project to the given
    ``traits`` that are present (in that order).

    Shared by scan trimming (``_scan_into``), plan subsumption
    (``ImmutableUIHStore._carve``) and union-window tenant views
    (``projection.project_view``) — one implementation is what makes the
    "carved view == solo scan" byte-identity hold by construction."""
    n = batch_len(batch)
    if max_events >= 0 and n > max_events:
        batch = slice_batch(batch, n - max_events, n)
    if traits is not None:
        batch = project_traits(batch, [t for t in traits if t in batch])
    return batch


def merge_sorted(batches: Sequence[EventBatch]) -> EventBatch:
    """k-way merge by timestamp (stable). Used by mutable-store merge-on-read and
    by compaction. Inputs may individually be unsorted (blind-write appends)."""
    cat = concat_batches(batches)
    if not cat:
        return cat
    order = np.argsort(cat["timestamp"], kind="stable")
    return take_batch(cat, order)


# ---------------------------------------------------------------------------
# Synthetic event-stream generator
# ---------------------------------------------------------------------------

MS_PER_DAY = 86_400_000


@dataclasses.dataclass
class StreamConfig:
    n_users: int = 64
    n_items: int = 50_000
    n_creators: int = 5_000
    n_categories: int = 64
    n_action_types: int = 8
    n_surfaces: int = 4
    days: int = 8
    events_per_user_day_mean: float = 40.0
    like_rate: float = 0.06
    comment_rate: float = 0.015
    share_rate: float = 0.008
    seed: int = 0


class SyntheticEventStream:
    """Deterministic synthetic UIH generator.

    Item popularity is Zipfian, engagement flags are sparse (matching the density
    assumptions behind the trait-aware codec), timestamps arrive in bursty
    sessions within each day.
    """

    def __init__(self, cfg: StreamConfig, schema: Optional[TraitSchema] = None):
        self.cfg = cfg
        self.schema = schema or default_schema()
        self._rng = np.random.default_rng(cfg.seed)
        # Zipf item weights
        ranks = np.arange(1, cfg.n_items + 1, dtype=np.float64)
        w = 1.0 / ranks**1.1
        self._item_p = w / w.sum()
        self._item_creator = self._rng.integers(0, cfg.n_creators, size=cfg.n_items)
        self._item_category = self._rng.integers(0, cfg.n_categories, size=cfg.n_items)

    def day_events(self, user_id: int, day: int) -> EventBatch:
        """All events of ``user_id`` during ``day`` (timestamps in ms)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, user_id, day))
        n = int(rng.poisson(cfg.events_per_user_day_mean))
        if n == 0:
            return empty_batch(self.schema)
        # bursty sessions: a few session starts, events clustered after them
        n_sessions = max(1, int(rng.integers(1, 5)))
        starts = np.sort(rng.integers(0, MS_PER_DAY - 3_600_000, size=n_sessions))
        sess = rng.integers(0, n_sessions, size=n)
        ts = day * MS_PER_DAY + starts[sess] + rng.integers(0, 3_600_000, size=n)
        ts = np.sort(ts).astype(np.int64)
        items = rng.choice(cfg.n_items, size=n, p=self._item_p).astype(np.int64)
        batch: EventBatch = {
            "timestamp": ts,
            "item_id": items,
            "action_type": rng.integers(0, cfg.n_action_types, size=n).astype(np.int32),
            "surface": rng.integers(0, cfg.n_surfaces, size=n).astype(np.int32),
            "watch_time_ms": np.maximum(
                0, (rng.gamma(2.0, 8_000.0, size=n)).astype(np.int32)
            ),
            "like": (rng.random(n) < cfg.like_rate).astype(np.int8),
            "comment": (rng.random(n) < cfg.comment_rate).astype(np.int8),
            "share": (rng.random(n) < cfg.share_rate).astype(np.int8),
            "category": self._item_category[items].astype(np.int32),
            "creator_id": self._item_creator[items].astype(np.int64),
        }
        return {k: batch[k] for k in self.schema.trait_names}

    def history_until(self, user_id: int, t: int, start_day: int = 0) -> EventBatch:
        """Full canonical history of ``user_id`` with timestamp <= t."""
        last_day = min(self.cfg.days - 1, t // MS_PER_DAY)
        days = [self.day_events(user_id, d) for d in range(start_day, last_day + 1)]
        return time_slice(merge_sorted(days), 0, t) if days else empty_batch(self.schema)
