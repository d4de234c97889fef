"""Declarative read-path specs (paper §2.3, §4.2): WHAT a tenant consumes,
not HOW the pipeline is wired.

A ``DatasetSpec`` is a frozen, hashable description of one model tenant's
feed: the data source (warehouse hour replay | live stream | sim examples),
the tenant's ``TenantProjection`` (sequence length, feature groups, traits),
the consistency mode, the generation policy, and the feed knobs (batch size,
prefetch depth, reshuffle seed, worker count). ``repro.data.open_feed``
compiles a spec into the existing data plane and returns a uniform ``Feed``;
``repro.data.MultiTenantPlanner`` co-plans N specs over the same store into
one union co-scan. Adding a tenant is a one-spec change, not a new pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.core import events as ev
from repro_torch.core.projection import TenantProjection
from repro_torch.dpp.featurize import FeatureSpec


@dataclasses.dataclass(frozen=True)
class WarehouseSource:
    """Batch replay of hourly warehouse partitions (user-bucketed buckets are
    the unit of work, preserving the §4.2.3 data-affinity clustering)."""

    hours: Optional[Tuple[int, ...]] = None   # None = every ingested hour
    epochs: int = 1

    def __post_init__(self):
        if self.hours is not None:
            object.__setattr__(self, "hours", tuple(self.hours))
        if self.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")


@dataclasses.dataclass(frozen=True)
class SimSource:
    """Replay of the sim's logged examples (benchmark / test / demo traffic),
    affinity-planned per epoch. ``min_rows`` repeats shuffled epochs until at
    least that many example rows are dispatched (how a step-bounded trainer
    sizes its feed)."""

    epochs: int = 1
    shuffle: bool = True
    min_rows: Optional[int] = None

    def __post_init__(self):
        if self.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")


@dataclasses.dataclass(frozen=True)
class StreamSource:
    """Live training-example stream, optionally preceded by the batch→stream
    catch-up backfill (warehouse replay with the exactly-once watermark).

    ``backfill_start_hour``/``backfill_end_hour`` bound the replay range
    (None = the warehouse's full sealed sweep at feed-open time). These are
    OPERATIONAL knobs, not dataset identity: a resumed feed may legitimately
    replay a longer range than the killed run did (the warehouse head moved),
    so they are excluded from the resume fingerprint."""

    backfill: bool = True
    micro_batch_examples: int = 8
    micro_batch_delay_s: float = 0.05
    backfill_start_hour: Optional[int] = None
    backfill_end_hour: Optional[int] = None

    def __post_init__(self):
        if self.micro_batch_examples < 1:
            raise ValueError("micro_batch_examples must be >= 1")


Source = Union[WarehouseSource, SimSource, StreamSource]

_CONSISTENCY = ("off", "audit")
_GENERATIONS = ("live", "pinned")


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """One tenant's declarative feed description.

    * ``source`` — where examples come from (warehouse | stream | sim);
    * ``tenant`` — the multi-dimensional projection pushed down to storage;
    * ``consistency`` — ``"audit"`` checksum-validates every full-window
      materialization (O2O), ``"off"`` trusts the protocol;
    * ``generations`` — ``"pinned"`` scans the example's logged (leased)
      generation byte-exact (the streaming protocol), ``"live"`` always
      re-resolves against the live generation;
    * feed knobs — full/base batch sizes, device prefetch depth, reshuffle
      seed, worker count, client buffering, per-worker window-cache size;
    * ``features`` — featurization spec; derived from the tenant's traits
      when omitted (every non-timestamp trait becomes a ``uih_*`` array).

    Frozen and hashable: specs can key plans, caches, and registries.
    """

    tenant: TenantProjection
    source: Source = dataclasses.field(default_factory=SimSource)
    consistency: str = "off"
    generations: str = "live"
    batch_size: int = 32
    base_batch_size: int = 8
    # None = auto: a device-prefetch stage (depth 2) iff open_feed targets a
    # cell; 0 = FORCE host feed even with a cell; >0 = explicit depth
    prefetch_depth: Optional[int] = None
    reshuffle_seed: Optional[int] = 0
    n_workers: int = 2
    buffer_batches: int = 4
    window_cache_size: int = 256
    features: Optional[FeatureSpec] = None
    # fault tolerance (§10): ``ordered`` routes finished base batches through
    # the pool's reorder buffer so full batches compose deterministically in
    # work-item order — the property crash-safe checkpoint/resume and the
    # byte-identical chaos guarantee rest on; ``max_item_retries`` bounds
    # pool-level self-healing (requeue + respawn) per work item, 0 = a worker
    # exception is immediately fatal (the pre-§10 behavior)
    ordered: bool = True
    max_item_retries: int = 3
    # device-side late materialization (DESIGN §3): ship compact jagged
    # payloads (arena + offsets) to the device-prefetch stage and run the
    # kernels/fused densify+decode on-accelerator instead of densifying on
    # the host. Batches are byte-identical to the host path (tested), so the
    # flag is an operational knob EXCLUDED from the resume fingerprint.
    # Requires a device-prefetch stage and no prep_fn; open_feed silently
    # falls back to the host path otherwise (fallback rules in DESIGN §3).
    device_materialize: bool = False
    # unified telemetry (§13): a ``repro.obs.Telemetry`` threaded by
    # ``open_feed`` through every pipeline stage (store RTT histograms, item
    # spans, control-plane events). Excluded from equality/hash/repr — an
    # observer is not dataset identity (and resume_fingerprint must not see
    # it; it builds from repr'd identity fields only).
    telemetry: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False, hash=False)

    def __post_init__(self):
        if self.consistency not in _CONSISTENCY:
            raise ValueError(
                f"consistency must be one of {_CONSISTENCY}, got "
                f"{self.consistency!r}")
        if self.generations not in _GENERATIONS:
            raise ValueError(
                f"generations must be one of {_GENERATIONS}, got "
                f"{self.generations!r}")
        if self.batch_size < 1 or self.base_batch_size < 1:
            raise ValueError("batch sizes must be >= 1")
        if self.prefetch_depth is not None and self.prefetch_depth < 0:
            raise ValueError("prefetch_depth must be >= 0 (or None = auto)")
        if self.n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if self.buffer_batches < 1:
            raise ValueError("buffer_batches must be >= 1")
        if self.window_cache_size < 0:
            raise ValueError("window_cache_size must be >= 0")
        if self.max_item_retries < 0:
            raise ValueError("max_item_retries must be >= 0")
        if (self.features is not None
                and self.features.seq_len != self.tenant.seq_len):
            # a mismatch silently truncates (or over-pads) every sequence the
            # tenant projection paid to fetch — wrong model config, not a knob
            raise ValueError(
                f"features.seq_len={self.features.seq_len} != "
                f"tenant.seq_len={self.tenant.seq_len}; the featurized length "
                f"must match the tenant projection")

    # -- compiled-policy views -------------------------------------------------
    @property
    def validate_checksum(self) -> bool:
        return self.consistency == "audit"

    @property
    def pin_generations(self) -> bool:
        return self.generations == "pinned"

    @property
    def streaming(self) -> bool:
        return isinstance(self.source, StreamSource)

    def resolve_features(self, schema: ev.TraitSchema) -> FeatureSpec:
        """The effective featurization: explicit ``features``, else derived
        from the tenant (each non-timestamp projected trait -> ``uih_*``)."""
        if self.features is not None:
            return self.features
        traits = tuple(t for t in self.tenant.all_traits(schema)
                       if t != "timestamp")
        return FeatureSpec(seq_len=self.tenant.seq_len, uih_traits=traits)


def resume_fingerprint(spec: DatasetSpec) -> str:
    """Dataset identity for checkpoint/resume compatibility (§10).

    Covers every field that determines WHAT rows the feed produces in WHICH
    order (tenant projection, features, source identity, batch size, reshuffle
    seed, consistency/generation policy, ordering). Deliberately EXCLUDES
    operational knobs that may legitimately change across restarts without
    breaking exactly-once: worker count, base batch size, buffering, prefetch
    depth, micro-batch bounds, and the streaming backfill hour range (the
    warehouse head moves between runs — the resumed sweep is *expected* to be
    longer than the killed run's)."""
    src = spec.source
    if isinstance(src, StreamSource):
        src_key: tuple = ("stream", src.backfill)
    elif isinstance(src, WarehouseSource):
        src_key = ("warehouse", src.hours, src.epochs)
    else:
        src_key = ("sim", src.epochs, src.shuffle, src.min_rows)
    return repr((repr(spec.tenant), src_key, spec.consistency,
                 spec.generations, spec.batch_size, spec.reshuffle_seed,
                 repr(spec.features), spec.ordered))
