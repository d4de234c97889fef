"""Featurization: materialized UIH event batches -> fixed-shape training arrays.

Pads/truncates the jagged per-example sequences into dense [B, L] arrays with a
validity mask (host-side numpy mirror of the ``repro.kernels.jagged`` Pallas
device kernel — see DESIGN.md §3 on where the device path takes over).

Two implementations coexist:

  * the **vectorized** path (``featurize``, ``pad_sequences``): the jagged
    per-example columns are flattened into a single values *arena* plus an
    ``offsets`` vector — the exact layout ``kernels/jagged`` consumes on
    device — and the dense [B, L] pad + mask are built with ONE fancy-index
    scatter shared across all traits (no per-example Python loop);
  * the **reference** path (``featurize_reference``, ``pad_sequences_reference``):
    the seed per-example-loop implementation, kept as the golden oracle —
    tests/test_feed.py proves the vectorized path byte-identical to it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import events as ev
from repro_torch.core.versioning import TrainingExample

_EMPTY_I64 = np.zeros(0, np.int64)


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Frozen + hashable (sequence fields normalized to tuples) so it can
    live inside a frozen ``repro.data.DatasetSpec``."""

    seq_len: int                       # padded UIH length
    uih_traits: Sequence[str]          # traits to lift into [B, L] arrays
    candidate_fields: Sequence[str] = ("item_id",)
    label_fields: Sequence[str] = ("click",)

    def __post_init__(self):
        object.__setattr__(self, "uih_traits", tuple(self.uih_traits))
        object.__setattr__(self, "candidate_fields",
                           tuple(self.candidate_fields))
        object.__setattr__(self, "label_fields", tuple(self.label_fields))


# ---------------------------------------------------------------------------
# Jagged arena: flattened values + offsets (the kernels/jagged layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScatterPlan:
    """Jagged layout of one base batch: clipped lengths + arena offsets.

    Built once per distinct per-example length signature and reused by every
    trait that shares it (the common case: all traits of a UIH batch are
    equal-length columns). ``mask`` is the [B, L] validity grid: a boolean
    scatter ``out[mask] = arena`` fills each row's valid span left-to-right
    with consecutive arena elements — exactly the per-example reference
    semantics, with ZERO per-example Python iterations (and the mask doubles
    as the batch's ``uih_mask`` output).
    """

    b: int
    seq_len: int
    left_align: bool
    lens: np.ndarray        # [B] int64, clipped to seq_len
    offsets: np.ndarray     # [B+1] int64 into the clipped arena
    _mask: Optional[np.ndarray] = None

    @property
    def total(self) -> int:
        return int(self.offsets[-1])

    @property
    def mask(self) -> np.ndarray:
        if self._mask is None:
            j = np.arange(self.seq_len)
            if self.left_align:
                self._mask = j < self.lens[:, None]
            else:
                self._mask = j >= (self.seq_len - self.lens)[:, None]
        return self._mask

    def scatter(self, arena: np.ndarray, out: Optional[np.ndarray] = None
                ) -> np.ndarray:
        """Densify ``arena`` into a fresh (or provided) [B, L] grid."""
        if out is None:
            out = np.zeros((self.b, self.seq_len), dtype=arena.dtype)
        if self.total:
            out[self.mask] = arena
        return out


def make_scatter_plan(raw_lens: np.ndarray, seq_len: int,
                      left_align: bool = False) -> ScatterPlan:
    lens = np.minimum(raw_lens.astype(np.int64), seq_len)
    b = len(lens)
    offsets = np.zeros(b + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return ScatterPlan(b=b, seq_len=seq_len, left_align=left_align,
                       lens=lens, offsets=offsets)


def arena_of(seqs: Sequence[np.ndarray], plan: ScatterPlan,
             dtype: np.dtype) -> np.ndarray:
    """Concatenate the kept (truncated-to-plan) tails into one flat arena."""
    if plan.total == 0:
        return np.zeros(0, dtype)
    tails = [s[-n:] if n else s[:0]
             for s, n in zip(seqs, plan.lens)]
    out = np.concatenate(tails)
    if out.dtype != dtype:
        out = out.astype(dtype)
    return out


@dataclasses.dataclass
class JaggedFeatures:
    """A featurized base batch in jagged (arena + offsets) form.

    ``values[trait]`` is the flat [total] arena of clipped sequence tails and
    ``offsets`` the shared [B+1] boundaries — directly consumable by
    ``repro.kernels.jagged.ops.jagged_to_padded`` on device; ``to_padded``
    is the host-side equivalent (single scatter, no loops).
    """

    values: Dict[str, np.ndarray]
    plan: ScatterPlan
    scalars: Dict[str, np.ndarray]   # per-example fields ([B])
    # per-trait plans; only differ from ``plan`` for traits that are missing
    # from some examples (schema evolution / partial projections)
    trait_plans: Optional[Dict[str, ScatterPlan]] = None

    @property
    def offsets(self) -> np.ndarray:
        return self.plan.offsets

    def plan_for(self, trait: str) -> ScatterPlan:
        if self.trait_plans is not None and trait in self.trait_plans:
            return self.trait_plans[trait]
        return self.plan

    def to_padded(self) -> Dict[str, np.ndarray]:
        p = self.plan
        batch: Dict[str, np.ndarray] = {
            "uih_len": p.lens.astype(np.int32)}
        for trait, arena in self.values.items():
            batch[f"uih_{trait}"] = self.plan_for(trait).scatter(arena)
        batch["uih_mask"] = p.mask if p.total else np.zeros(
            (p.b, p.seq_len), dtype=np.bool_)
        batch.update(self.scalars)
        return batch


# ---------------------------------------------------------------------------
# Vectorized path (default)
# ---------------------------------------------------------------------------

def pad_sequences(
    seqs: Sequence[np.ndarray], seq_len: int, dtype=None, left_align: bool = False
) -> np.ndarray:
    """Right-aligned (most-recent-last) pad/truncate to [B, seq_len].

    Vectorized: one concat of the kept tails + one fancy-index scatter."""
    b = len(seqs)
    dtype = dtype or (seqs[0].dtype if b else np.int64)
    out = np.zeros((b, seq_len), dtype=dtype)
    if b == 0:
        return out
    raw_lens = np.fromiter((len(s) for s in seqs), np.int64, count=b)
    plan = make_scatter_plan(raw_lens, seq_len, left_align=left_align)
    return plan.scatter(arena_of(seqs, plan, out.dtype), out)


def featurize_jagged(
    examples: Sequence[TrainingExample],
    uihs: Sequence[ev.EventBatch],
    spec: FeatureSpec,
) -> JaggedFeatures:
    """Build one base batch in arena+offsets form (no [B, L] densification).

    One ScatterPlan is shared by every trait whose per-example lengths match
    the batch lengths; traits missing from some examples (schema evolution /
    partial projections) fall back to a per-trait plan so ``to_padded`` stays
    byte-identical to the reference per-example path.
    """
    assert len(examples) == len(uihs)
    b = len(examples)
    raw_lens_l = [ev.batch_len(u) for u in uihs]
    raw_lens = np.asarray(raw_lens_l, np.int64) if b else np.zeros(0, np.int64)
    plan = make_scatter_plan(raw_lens, spec.seq_len)
    values: Dict[str, np.ndarray] = {}
    plans: Dict[str, ScatterPlan] = {}
    for trait in spec.uih_traits:
        cols = [u.get(trait, _EMPTY_I64) for u in uihs]
        dtype = cols[0].dtype if b else np.dtype(np.int64)
        if all(len(c) == n for c, n in zip(cols, raw_lens_l)):
            t_plan = plan
        else:  # trait missing from some examples: its own jagged structure
            t_plan = make_scatter_plan(
                np.asarray([len(c) for c in cols], np.int64), spec.seq_len)
        values[trait] = arena_of(cols, t_plan, dtype)
        plans[trait] = t_plan

    scalars: Dict[str, np.ndarray] = {}
    for f in spec.candidate_fields:
        scalars[f"cand_{f}"] = np.array(
            [e.candidate.get(f, 0) for e in examples], np.int64)
    for f in spec.label_fields:
        scalars[f"label_{f}"] = np.array(
            [e.labels.get(f, 0.0) for e in examples], np.float32)
    scalars["request_ts"] = np.array([e.request_ts for e in examples], np.int64)
    scalars["user_id"] = np.array([e.user_id for e in examples], np.int64)
    return JaggedFeatures(values=values, plan=plan, scalars=scalars,
                          trait_plans=plans)


def featurize(
    examples: Sequence[TrainingExample],
    uihs: Sequence[ev.EventBatch],
    spec: FeatureSpec,
) -> Dict[str, np.ndarray]:
    """Build one base batch of dense arrays from materialized UIH sequences.

    Vectorized: arena + shared scatter; byte-identical to
    ``featurize_reference`` (proven in tests/test_feed.py)."""
    return featurize_jagged(examples, uihs, spec).to_padded()


# ---------------------------------------------------------------------------
# Reference path (the seed implementation, kept as the golden oracle)
# ---------------------------------------------------------------------------

def pad_sequences_reference(
    seqs: Sequence[np.ndarray], seq_len: int, dtype=None, left_align: bool = False
) -> np.ndarray:
    """Seed per-example-loop pad/truncate (golden oracle for ``pad_sequences``)."""
    b = len(seqs)
    dtype = dtype or (seqs[0].dtype if b else np.int64)
    out = np.zeros((b, seq_len), dtype=dtype)
    for i, s in enumerate(seqs):
        s = s[-seq_len:]
        if left_align:
            out[i, : len(s)] = s
        else:
            out[i, seq_len - len(s):] = s
    return out


def featurize_reference(
    examples: Sequence[TrainingExample],
    uihs: Sequence[ev.EventBatch],
    spec: FeatureSpec,
) -> Dict[str, np.ndarray]:
    """Seed per-example-loop featurizer (golden oracle for ``featurize``)."""
    assert len(examples) == len(uihs)
    b = len(examples)
    lens = np.array([min(ev.batch_len(u), spec.seq_len) for u in uihs], np.int32)
    batch: Dict[str, np.ndarray] = {"uih_len": lens}
    for trait in spec.uih_traits:
        cols = [u.get(trait, np.zeros(0, np.int64)) for u in uihs]
        batch[f"uih_{trait}"] = pad_sequences_reference(cols, spec.seq_len)
    mask = np.zeros((b, spec.seq_len), dtype=np.bool_)
    for i, n in enumerate(lens):
        mask[i, spec.seq_len - n:] = True
    batch["uih_mask"] = mask
    for f in spec.candidate_fields:
        batch[f"cand_{f}"] = np.array(
            [e.candidate.get(f, 0) for e in examples], np.int64
        )
    for f in spec.label_fields:
        batch[f"label_{f}"] = np.array(
            [e.labels.get(f, 0.0) for e in examples], np.float32
        )
    batch["request_ts"] = np.array([e.request_ts for e in examples], np.int64)
    batch["user_id"] = np.array([e.user_id for e in examples], np.int64)
    return batch


def merge_base_batches(batches: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = batches[0].keys()
    return {k: np.concatenate([b[k] for b in batches], axis=0) for k in keys}


def reshuffle(batch: Dict[str, np.ndarray], seed: int) -> Dict[str, np.ndarray]:
    n = len(next(iter(batch.values())))
    perm = np.random.default_rng(seed).permutation(n)
    return {k: v[perm] for k, v in batch.items()}
