"""The least bytes a ``fused_densify`` launch must move.

One launch densifies one group of traits that share a jagged layout: each
kept arena element of each trait is read once (int32), the ``B + 1``
offsets once, and the ``[B, L]`` int32 lane of each trait written once;
with a timestamp lane, each row's int64 base is read once and the ``[B, L]``
int64 timestamps written once. An empty arena launches nothing.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA's data sheet


def launch_bytes(kept: int, b: int, seq_len: int, traits: int,
                 ts: bool) -> int:
    n = kept * traits * 4 + (b + 1) * 4 + b * seq_len * traits * 4
    if ts:
        n += b * 8 + b * seq_len * 8
    return n


def of_payload(payload: dict, ts_trait: str = "timestamp") -> Tuple[int, int]:
    """(least bytes, launches) of the launches a compact payload calls for:
    one for the traits sharing the row lengths ``uih_len``, one for each
    trait with offsets of its own."""
    seq_len = int(payload["_seq_len"])
    lens = np.asarray(payload["uih_len"])
    b = len(lens)
    arenas = [k[len("_arena_"):] for k in payload if k.startswith("_arena_")]
    shared = [t for t in arenas if f"_offsets_{t}" not in payload]
    total, launches = 0, 0
    kept = int(lens.sum())
    if shared and kept:
        ts = any(t == ts_trait and np.asarray(payload[f"_arena_{t}"]).dtype
                 == np.int64 for t in shared)
        total += launch_bytes(kept, b, seq_len, len(shared), ts)
        launches += 1
    for t in arenas:
        if t in shared:
            continue
        own = int(np.diff(np.asarray(payload[f"_offsets_{t}"])).sum())
        if own:
            ts = t == ts_trait and np.asarray(
                payload[f"_arena_{t}"]).dtype == np.int64
            total += launch_bytes(own, b, seq_len, 1, ts)
            launches += 1
    return total, launches
