"""Trainer-side DPP client (paper §4.2.1): slot-based zero-copy rebatching.

DPP workers emit *base batches* sized to their memory budget; the trainer-side
client asynchronously buffers, merges, and reshuffles them into the model's
full batch. This decouples worker memory pressure from the GPU's large-batch
requirement and raises worker thread concurrency.

The seed implementation merged pending base batches with an ``np.concatenate``
copy and then applied the reshuffle permutation with a second full-batch
gather copy. This version preallocates full-batch arrays as reusable *slots*
and writes each base batch's rows directly into the slot at **write-time
permuted offsets** — the reshuffle is fused into placement, so each row is
copied exactly once (base batch -> slot) and slot storage is recycled via
``recycle()`` instead of reallocated. Reproducibility: the permutation for
the k-th emitted full batch is keyed on the producer-side emit counter k
(``shuffle_seed + k``), which makes the output byte-identical to the seed
``merge_base_batches`` + ``reshuffle`` path (proven in tests/test_feed.py).

Also hosts the GPU-starvation accounting the elastic controller consumes.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Deque, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.dpp.featurize import JaggedFeatures, merge_base_batches, reshuffle
from repro_torch.obs.spans import current_span


@dataclasses.dataclass
class ClientStats:
    full_batches: int = 0
    starved_time_s: float = 0.0    # trainer waited on data (GPU idle)
    train_time_s: float = 0.0      # trainer consumed data (GPU busy)
    # split of starved_time_s by what the feed was doing while the trainer
    # waited (populated by DevicePrefetcher; without one, waits are host waits)
    starved_host_s: float = 0.0    # waiting on host-side data production
    starved_h2d_s: float = 0.0     # waiting on the host->device copy
    h2d_time_s: float = 0.0        # total device_put time (overlapped or not)
    h2d_bytes: int = 0             # bytes actually shipped host->device
    slot_reuses: int = 0           # full batches served from a recycled slot

    @property
    def starvation_pct(self) -> float:
        total = self.starved_time_s + self.train_time_s
        if total <= 0:
            return 0.0
        return 100.0 * self.starved_time_s / total


class _Slot:
    """One in-flight full batch: preallocated arrays + fill bookkeeping.

    ``filled`` counts RESERVED rows (bumped under the client lock);
    ``writers`` counts producer threads still copying into their reserved
    span — the slot is emitted when it is fully reserved AND all copies
    landed, so the memory-bandwidth work itself runs outside the lock.
    """

    __slots__ = ("arrays", "filled", "writers", "emitted", "inv", "emit_seq",
                 "spans")

    def __init__(self, arrays: Dict[str, np.ndarray], inv: Optional[np.ndarray],
                 emit_seq: int):
        self.arrays = arrays
        self.filled = 0
        self.writers = 0
        self.emitted = False
        self.inv = inv          # arrival row -> slot row (None = identity)
        self.emit_seq = emit_seq
        # item spans whose rows landed here (telemetry only; see DESIGN §13)
        self.spans: List = []


class RebatchingClient:
    """Merges base batches of size b into full batches of size B = k*b.

    ``put`` is called by DPP worker threads; ``get_full_batch`` by the trainer.
    The consumer may hand a finished batch's storage back via ``recycle`` —
    the arrays are then reused for a future slot instead of reallocated
    (callers that retain references must skip recycling, which is always safe:
    the client simply allocates fresh storage).
    """

    def __init__(
        self,
        full_batch_size: int,
        buffer_batches: int = 8,
        shuffle_seed: Optional[int] = 0,
        emit_seq_start: int = 0,
        emit_jagged: bool = False,
    ):
        self.full_batch_size = full_batch_size
        # jagged-emission mode (device-side late materialization, DESIGN §3):
        # slots hold per-row arena VIEWS instead of dense [B, L] storage and
        # each emitted full batch is a COMPACT payload (flat arena + offsets
        # per trait) for the DevicePrefetcher's materializer — the [B, L]
        # zero-padded grids are never built on the host
        self.emit_jagged = emit_jagged
        self._jagged_meta: Optional[dict] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_batches)
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self.shuffle_seed = shuffle_seed
        # producer-side emit counter: the reshuffle seed must NOT depend on
        # stats.full_batches (incremented by the CONSUMER), else the shuffle
        # of batch k varies with trainer timing and runs aren't reproducible.
        # ``emit_seq_start`` resumes the counter after a crash (Feed
        # checkpoint/resume): batch k of the resumed run reshuffles exactly
        # like batch ``start + k`` of the uninterrupted run would have.
        self._emit_seq = emit_seq_start
        self._slot: Optional[_Slot] = None      # the single partially-filled slot
        self._free: List[Dict[str, np.ndarray]] = []   # recycled slot storage
        self._max_free = buffer_batches
        self.stats = ClientStats()
        # row count of each emitted batch, in emission order (opt-in): the
        # Feed's crash-safe cursor reads delivered-batch sizes from here
        # instead of inspecting batch arrays (a prep_fn may reshape them).
        # Exact under single-emitter ordering (the pool's placer / close());
        # consumers that bypass the Feed (shutdown drains) leave stale
        # entries behind, which is fine — checkpoints are never taken after
        # training stopped. Off by default so feeds without a checkpointing
        # consumer never accrete it.
        self.track_emitted_rows = False
        self.emitted_rows: Deque[int] = collections.deque()
        # optional per-run telemetry (repro.obs.Telemetry): the emit point —
        # each committed slot's contributing item spans become a BatchSpan
        # riding a FIFO parallel to the output queue
        self.telemetry = None
        # end-of-stream sentinel observed by the consumer: lets a wall-clock-
        # bounded trainer distinguish "stream over" from "get timed out"
        self.ended = False

    # -- slot machinery ----------------------------------------------------------
    def _perm_inv(self, emit_seq: int, n: int) -> Optional[np.ndarray]:
        """Inverse permutation for the k-th emitted batch: arrival row r lands
        at slot row inv[r], equivalent to ``reshuffle(batch, seed + k)``."""
        if self.shuffle_seed is None:
            return None
        perm = np.random.default_rng(self.shuffle_seed + emit_seq).permutation(n)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n, dtype=np.int64)
        return inv

    def _new_slot(self, template: Dict[str, np.ndarray]) -> _Slot:
        """Allocate (or recycle) full-batch storage shaped like ``template``."""
        b = self.full_batch_size
        arrays: Optional[Dict[str, np.ndarray]] = None
        if self._free:
            cand = self._free.pop()
            if (cand.keys() == template.keys() and all(
                    cand[k].shape[1:] == template[k].shape[1:]
                    and cand[k].dtype == template[k].dtype
                    for k in template)):
                arrays = cand
                self.stats.slot_reuses += 1
            # else: shape/schema changed mid-stream — drop and reallocate
        if arrays is None:
            arrays = {k: np.empty((b,) + v.shape[1:], v.dtype)
                      for k, v in template.items()}
        slot = _Slot(arrays, self._perm_inv(self._emit_seq, b), self._emit_seq)
        self._emit_seq += 1
        return slot

    def _write_rows(self, slot: _Slot, base: Dict[str, np.ndarray],
                    src_lo: int, src_hi: int, lo: int) -> None:
        """Copy base rows [src_lo, src_hi) into slot span [lo, ...) at
        permuted offsets. Runs OUTSIDE the client lock (disjoint spans)."""
        if base.keys() != slot.arrays.keys():
            # a short-keyed batch would otherwise fill its span PARTIALLY and
            # leave stale slot data in the missing columns (the seed concat
            # path raised here too)
            raise KeyError(
                f"base batch keys {sorted(base)} != slot keys "
                f"{sorted(slot.arrays)}")
        n = src_hi - src_lo
        if slot.inv is None:
            for k, v in base.items():
                slot.arrays[k][lo : lo + n] = v[src_lo:src_hi]
        else:
            dest = slot.inv[lo : lo + n]
            for k, v in base.items():
                slot.arrays[k][dest] = v[src_lo:src_hi]

    def _commit(self, slot: _Slot, ok: bool) -> None:
        """Mark a reserved span done; emit the slot once complete. A failed
        span poisons the slot — half-written batches must never reach the
        trainer (the producer's exception propagates regardless)."""
        with self._lock:
            slot.writers -= 1
            if not ok:
                slot.emitted = True   # poison: complete but never queued
                if self._slot is slot:
                    self._slot = None   # later puts start a fresh slot
                return
            done = (slot.filled == self.full_batch_size
                    and slot.writers == 0 and not slot.emitted)
            if done:
                slot.emitted = True
        if done:
            # emit OUTSIDE the lock: the bounded queue may block on a slow
            # consumer and producers must not hold the slot lock meanwhile
            if self.track_emitted_rows:
                self.emitted_rows.append(self.full_batch_size)
            if self.telemetry is not None:
                # slot.spans is frozen here: the slot is fully reserved and
                # its last writer just committed
                self.telemetry.spans.emit_batch(
                    slot.emit_seq, slot.spans, self.full_batch_size)
            self._q.put(self._pack_jagged(slot.arrays)
                        if self.emit_jagged else slot.arrays)

    def _place(self, rows: int, template_fn, write_fn) -> None:
        """Shared reservation loop for ``put``/``put_jagged``: reserve a span
        under the lock, copy it OUTSIDE the lock (spans are disjoint, so N
        workers place rows concurrently instead of serializing the batch's
        memory-bandwidth work), and commit in a ``finally`` so a failed write
        cannot leak ``writers`` and hang ``close()``."""
        src = 0
        while src < rows:
            with self._lock:
                if self._slot is None:
                    self._slot = self._new_slot(template_fn())
                slot = self._slot
                lo = slot.filled
                take = min(rows - src, self.full_batch_size - lo)
                slot.filled += take
                slot.writers += 1
                if self.telemetry is not None:
                    sp = current_span()
                    if sp is not None and (
                            not slot.spans or slot.spans[-1] is not sp):
                        slot.spans.append(sp)
                if slot.filled == self.full_batch_size:
                    self._slot = None   # fully reserved; next put starts fresh
            ok = False
            try:
                write_fn(slot, src, src + take, lo)
                ok = True
            finally:
                self._commit(slot, ok)
            src += take

    # -- producer side (DPP workers) --------------------------------------------
    def put(self, base_batch: Dict[str, np.ndarray]) -> None:
        if self.emit_jagged:
            raise TypeError(
                "client is in jagged-emission mode (emit_jagged=True): dense "
                "base batches would force the host densify the mode exists "
                "to eliminate — produce JaggedFeatures and use put_jagged")
        rows = len(next(iter(base_batch.values())))
        self._place(
            rows, lambda: base_batch,
            lambda slot, a, b, lo: self._write_rows(slot, base_batch, a, b, lo))

    # -- fused jagged placement ---------------------------------------------------
    def _jagged_template(self, jf: JaggedFeatures) -> Dict[str, np.ndarray]:
        """Zero-row template describing the full-batch arrays a JaggedFeatures
        base batch densifies into (same keys/dtypes/orders as ``to_padded``)."""
        p = jf.plan
        t: Dict[str, np.ndarray] = {"uih_len": np.zeros((0,), np.int32)}
        for trait, arena in jf.values.items():
            t[f"uih_{trait}"] = np.zeros((0, p.seq_len), arena.dtype)
        t["uih_mask"] = np.zeros((0, p.seq_len), np.bool_)
        for k, v in jf.scalars.items():
            t[k] = np.zeros((0,) + v.shape[1:], v.dtype)
        return t

    def _write_jagged(self, slot: _Slot, jf: JaggedFeatures,
                      src_lo: int, src_hi: int, lo: int) -> None:
        """Scatter arena elements of arrival rows [src_lo, src_hi) straight
        into slot span [lo, ...) at write-time-permuted offsets —
        densification, pad, mask, and reshuffle fused into ONE pass (no
        intermediate base batch). Runs OUTSIDE the client lock.
        """
        n = src_hi - src_lo
        L = jf.plan.seq_len
        if slot.inv is None:
            dest = np.arange(lo, lo + n, dtype=np.int64)
        else:
            dest = slot.inv[lo : lo + n]
        # per-(plan, span) flat destination indices, shared across traits:
        # element j of arrival row r lands at dest[r]*L + (L - len[r]) + j
        flat_cache: Dict[int, np.ndarray] = {}

        def flat_for(plan) -> np.ndarray:
            key = id(plan)
            hit = flat_cache.get(key)
            if hit is not None:
                return hit
            seg = plan.lens[src_lo:src_hi]
            base = plan.offsets[src_lo:src_hi] - plan.offsets[src_lo]
            shift = dest * L + (L - seg) - base
            flat = np.arange(int(seg.sum()), dtype=np.int64) \
                + np.repeat(shift, seg)
            flat_cache[key] = flat
            return flat

        # padding must read as zeros: wipe the destination rows (row-wise
        # memset), then scatter only the valid elements
        slot.arrays["uih_len"][dest] = jf.plan.lens[src_lo:src_hi].astype(np.int32)
        for trait, arena in jf.values.items():
            plan = jf.plan_for(trait)
            arr = slot.arrays[f"uih_{trait}"]
            arr[dest] = 0
            span = arena[plan.offsets[src_lo] : plan.offsets[src_hi]]
            if len(span):
                arr.reshape(-1)[flat_for(plan)] = span
        m = slot.arrays["uih_mask"]
        m[dest] = False
        mf = flat_for(jf.plan)
        if len(mf):
            m.reshape(-1)[mf] = True
        for k, v in jf.scalars.items():
            slot.arrays[k][dest] = v[src_lo:src_hi]

    def put_jagged(self, jf: JaggedFeatures) -> None:
        """Place a jagged (arena + offsets) base batch without densifying it
        first: one fused scatter per trait, reshuffle folded into placement.
        Byte-identical to ``put(jf.to_padded())`` (tests/test_feed.py).

        In jagged-EMISSION mode the densify is skipped entirely: slots store
        per-row arena views and the full batch leaves as a compact payload
        (see ``_pack_jagged``) for the device-side fused kernel."""
        if self.emit_jagged:
            self._place(
                jf.plan.b, lambda: self._jagged_emit_template(jf),
                lambda slot, a, b, lo: self._write_jagged_rows(
                    slot, jf, a, b, lo))
            return
        self._place(
            jf.plan.b, lambda: self._jagged_template(jf),
            lambda slot, a, b, lo: self._write_jagged(slot, jf, a, b, lo))

    # -- jagged emission (device-side late materialization) -----------------------
    def _jagged_emit_template(self, jf: JaggedFeatures) -> Dict[str, np.ndarray]:
        """Slot template for jagged-emission mode: one object column of row
        views per trait plus the [B] scalar columns — no [B, L] storage."""
        if self._jagged_meta is None:
            self._jagged_meta = {
                "seq_len": jf.plan.seq_len,
                "traits": [(t, np.asarray(a).dtype)
                           for t, a in jf.values.items()],
                "scalar_keys": list(jf.scalars),
            }
        t: Dict[str, np.ndarray] = {"uih_len": np.zeros((0,), np.int32)}
        for trait, _ in self._jagged_meta["traits"]:
            t[f"_rows_{trait}"] = np.zeros((0,), object)
        for k in self._jagged_meta["scalar_keys"]:
            v = jf.scalars[k]
            t[k] = np.zeros((0,) + v.shape[1:], v.dtype)
        return t

    def _write_jagged_rows(self, slot: _Slot, jf: JaggedFeatures,
                           src_lo: int, src_hi: int, lo: int) -> None:
        """Jagged-emission placement: store each arrival row's clipped-tail
        arena VIEW at its write-time-permuted slot position — zero row copies
        until emit concatenates the full batch's arena. Runs OUTSIDE the
        client lock."""
        meta = self._jagged_meta
        if ([t for t, _ in meta["traits"]] != list(jf.values)
                or meta["scalar_keys"] != list(jf.scalars)):
            # same contract as the dense path: a schema-drifting base batch
            # must fail loudly, not leave stale columns behind
            raise KeyError(
                f"base batch schema {sorted(jf.values)}/{sorted(jf.scalars)} "
                f"!= slot schema {sorted(t for t, _ in meta['traits'])}/"
                f"{sorted(meta['scalar_keys'])}")
        n = src_hi - src_lo
        if slot.inv is None:
            dest = np.arange(lo, lo + n, dtype=np.int64)
        else:
            dest = slot.inv[lo : lo + n]
        slot.arrays["uih_len"][dest] = \
            jf.plan.lens[src_lo:src_hi].astype(np.int32)
        for trait, arena in jf.values.items():
            offs = jf.plan_for(trait).offsets
            cells = np.empty(n, object)
            cells[:] = [arena[offs[src_lo + i]:offs[src_lo + i + 1]]
                        for i in range(n)]
            slot.arrays[f"_rows_{trait}"][dest] = cells
        for k, v in jf.scalars.items():
            slot.arrays[k][dest] = v[src_lo:src_hi]

    def _pack_jagged(self, arrays: Dict[str, np.ndarray],
                     idx: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """A completed jagged slot -> the compact emitted payload:

        ``uih_len`` [B] int32, one flat ``_arena_<trait>`` per trait (its
        per-row offsets are the cumsum of ``uih_len`` clipped lens; traits
        with their OWN plan — schema evolution — add ``_offsets_<trait>``),
        the scalar columns, and ``_seq_len``. The DevicePrefetcher's
        materializer turns this into the dense device batch; the layout
        contract lives in DESIGN §3."""
        meta = self._jagged_meta
        lens = arrays["uih_len"] if idx is None else arrays["uih_len"][idx]
        b = len(lens)
        shared = np.zeros(b + 1, np.int64)
        shared[1:] = np.cumsum(lens, dtype=np.int64)
        out: Dict[str, np.ndarray] = {"uih_len": lens}
        for trait, dtype in meta["traits"]:
            rows = arrays[f"_rows_{trait}"]
            if idx is not None:
                rows = rows[idx]
            tl = np.fromiter((r.shape[0] for r in rows), np.int64, count=b)
            offs = np.zeros(b + 1, np.int64)
            offs[1:] = np.cumsum(tl)
            arena = (np.concatenate(list(rows)) if offs[-1]
                     else np.zeros(0, dtype))
            if arena.dtype != dtype:
                arena = arena.astype(dtype)
            out[f"_arena_{trait}"] = arena
            if not np.array_equal(offs, shared):
                out[f"_offsets_{trait}"] = offs
        out["_seq_len"] = np.int64(meta["seq_len"])
        for k in meta["scalar_keys"]:
            out[k] = arrays[k] if idx is None else arrays[k][idx]
        return out

    def recycle(self, batch: Dict[str, np.ndarray]) -> None:
        """Return a consumed full batch's storage to the slot pool."""
        if self.emit_jagged:
            return   # payloads are packed fresh at emit; slots hold views
        with self._lock:
            if len(self._free) < self._max_free:
                self._free.append(batch)

    def close(self) -> None:
        """Flush the pending remainder as a final short batch, then signal end
        of stream (the tail of an epoch must not be silently dropped).

        Call AFTER all producers finished their ``put``s; any straggler still
        copying its reserved span is waited out before the tail is read."""
        self._closed.set()
        with self._lock:
            slot, self._slot = self._slot, None
        if slot is not None and slot.filled:
            while True:
                with self._lock:
                    if slot.writers == 0:
                        poisoned = slot.emitted
                        break
                time.sleep(0.001)
            if poisoned:   # a failed span: drop the tail, do not emit garbage
                self._q.put(None)
                return
            n = slot.filled
            # the tail was written at full-batch permuted offsets; recover
            # arrival order, then reshuffle over the ACTUAL length n exactly
            # like the seed path's close() did
            if slot.inv is None:
                if self.emit_jagged:
                    tail = self._pack_jagged(
                        slot.arrays, np.arange(n, dtype=np.int64))
                else:
                    tail = {k: v[:n] for k, v in slot.arrays.items()}
            else:
                order = slot.inv[:n]
                if self.emit_jagged:
                    # same semantics as the dense tail below: recover arrival
                    # order, then reshuffle over the ACTUAL length n
                    perm = np.random.default_rng(
                        self.shuffle_seed + slot.emit_seq).permutation(n)
                    tail = self._pack_jagged(slot.arrays, order[perm])
                else:
                    tail = {k: v[order] for k, v in slot.arrays.items()}
                    tail = reshuffle(tail, self.shuffle_seed + slot.emit_seq)
            if self.track_emitted_rows:
                self.emitted_rows.append(n)
            if self.telemetry is not None:
                self.telemetry.spans.emit_batch(slot.emit_seq, slot.spans, n)
            self._q.put(tail)
        self._q.put(None)

    # -- consumer side (trainer loop) --------------------------------------------
    def get_full_batch(self, timeout: Optional[float] = None, record: bool = True):
        t0 = time.perf_counter()
        try:
            out = self._q.get(timeout=timeout)
            if out is None:
                self.ended = True
        except queue.Empty:
            out = None
        if out is not None and record:
            # only waits that END IN A DELIVERED BATCH are GPU starvation: a
            # timeout or the end-of-stream sentinel would otherwise inflate
            # starvation_pct after the stream is drained
            dt = time.perf_counter() - t0
            self.stats.starved_time_s += dt
            self.stats.starved_host_s += dt
            self.stats.full_batches += 1
        return out

    def record_train_step(self, seconds: float) -> None:
        self.stats.train_time_s += seconds

    def stats_snapshot(self) -> ClientStats:
        """Consistent point-in-time copy of the counters (Feed.snapshot())."""
        with self._lock:
            return dataclasses.replace(self.stats)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.get_full_batch()
            if b is None:
                return
            yield b
