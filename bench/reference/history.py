"""Plain reference of the read path: each example's history window and the
dense batch a trainer should receive, worked out again from the generated
events and requests.

An example is a request ``(user, request_ts)``; its history is every event
of that user with ``max(0, request_ts - lookback) <= timestamp <=
request_ts``, in time order, cut to its newest ``seq_len`` events and laid
out right-aligned in ``[B, seq_len]`` lanes with zeros before it and a mask
of the kept positions. The candidate's fields, the labels, the request time
and the user ride along as ``[B]`` columns.

Plain NumPy; imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from bench.reference.events import EventStream, Request

Batch = Dict[str, np.ndarray]


Key = Tuple[int, int, int]          # (user, request_ts, candidate item)


def dense_batch(stream: EventStream, requests: Dict[Key, Request],
                rows: Iterable[Key], lookback_ms: int,
                seq_len: int, traits: Sequence[str],
                cand_fields: Sequence[str], label_fields: Sequence[str]
                ) -> Tuple[Batch, np.ndarray]:
    """(the dense batch of ``rows``, its kept timestamps ``[B, seq_len]``).
    A row that is no request of the schedule is left all zeros."""
    rows = list(rows)
    b = len(rows)
    out: Batch = {"uih_len": np.zeros(b, np.int64)}
    lanes = {t: np.zeros((b, seq_len), np.int64) for t in traits}
    stamps = np.zeros((b, seq_len), np.int64)
    cols = {f"cand_{f}": np.zeros(b, np.int64) for f in cand_fields}
    cols.update({f"label_{f}": np.zeros(b, np.float32) for f in label_fields})
    for i, key in enumerate(rows):
        req = requests.get(key)
        if req is None:
            continue
        uid, ts = req.user_id, req.request_ts
        ev = stream.window(uid, max(0, ts - lookback_ms), ts)
        n = min(len(ev["timestamp"]), seq_len)
        out["uih_len"][i] = n
        if n:
            for t in traits:
                lanes[t][i, seq_len - n:] = ev[t][-n:]
            stamps[i, seq_len - n:] = ev["timestamp"][-n:]
        for f in cand_fields:
            cols[f"cand_{f}"][i] = req.cand_item_id if f == "item_id" else 0
        for f in label_fields:
            cols[f"label_{f}"][i] = req.click if f == "click" else 0.0
    for t in traits:
        out[f"uih_{t}"] = lanes[t]
    j = np.arange(seq_len)
    out["uih_mask"] = j >= (seq_len - out["uih_len"])[:, None]
    out.update(cols)
    known = [k if k in requests else (0, 0, 0) for k in rows]
    out["request_ts"] = np.array([k[1] for k in known], np.int64)
    out["user_id"] = np.array([k[0] for k in known], np.int64)
    return out, stamps


def canonical(batch: Batch, stamps: np.ndarray, mask: np.ndarray,
              traits: Sequence[str]) -> Batch:
    """``batch`` with the events of each run of equal timestamps (by the
    reference's ``stamps`` and ``mask``) sorted by their trait values: the
    order of two events logged in the same millisecond is not part of the
    result."""
    same = np.zeros_like(stamps, dtype=bool)
    same[:, 1:] = (stamps[:, 1:] == stamps[:, :-1]) & mask[:, 1:]
    if not same.any():
        return batch
    lanes = [f"uih_{t}" for t in traits
             if np.shape(batch.get(f"uih_{t}")) == stamps.shape]
    out = {k: (v.copy() if k in lanes else v) for k, v in batch.items()}
    for i in np.flatnonzero(same.any(axis=1)):
        j = 1
        row = same[i]
        while j < len(row):
            if not row[j]:
                j += 1
                continue
            a = j - 1
            while j < len(row) and row[j]:
                j += 1
            keys = [out[k][i, a:j] for k in reversed(lanes)]
            order = np.lexsort(keys)
            for k in lanes:
                out[k][i, a:j] = out[k][i, a:j][order]
    return out


def mismatches(got: Batch, want: Batch) -> int:
    """Elements of ``want`` that ``got`` does not hold (a missing key or a
    shape that differs counts every element of that key)."""
    bad = 0
    for k, w in want.items():
        g = got.get(k)
        if g is None or np.shape(g) != np.shape(w):
            bad += int(np.size(w))
            continue
        bad += int(np.count_nonzero(np.asarray(g).astype(w.dtype) != w))
    return bad


def requests_by_key(reqs: List[Request]) -> Dict[Key, Request]:
    return {(r.user_id, r.request_ts, r.cand_item_id): r for r in reqs}
