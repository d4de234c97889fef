"""Device-side late materialization: the host<->device handover adapter.

Port of ``repro.dpp.device_mat``. ``RebatchingClient(emit_jagged=True)`` emits
compact payloads (flat arena + offsets per trait) instead of dense [B, L]
batches. ``DeviceMaterializer`` runs inside the DevicePrefetcher's transfer
thread: it uploads ONLY the compact arrays (the zero padding never crosses
PCIe) from pinned host memory with non-blocking copies, launches the
``kernels/fused`` CUDA kernel once per shared-plan trait group, and rebuilds
exactly the batch dict ``densify_host`` produces — same keys, same order,
same host dtypes, same bytes (timestamps exact int64).

The embedding lookup stays OUT of this adapter for training: the table is a
trained parameter inside the step, so the fusion boundary is decode+densify.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.kernels.fused.ops import (
    fused_densify,
    pack_arena,
    ts_delta_encode,
    unpack_dense,
)

HostBatch = Dict[str, np.ndarray]


def is_jagged_batch(batch: Any) -> bool:
    """True for compact payloads from a jagged-emission client."""
    return isinstance(batch, dict) and "_seq_len" in batch


def jagged_batch_nbytes(batch: HostBatch) -> int:
    """Bytes this payload ships over H2D (arena/offsets/scalars; the metadata
    scalar ``_seq_len`` stays host-side)."""
    total = 0
    for k, v in batch.items():
        if k == "_seq_len":
            continue
        a = np.asarray(v)
        if k.startswith("_arena_") and a.dtype == np.int64:
            # int64 arenas upload as int32 (canonicalization / delta packing)
            total += a.size * 4
        else:
            total += a.nbytes
    return total


def densify_host(batch: HostBatch) -> HostBatch:
    """Host-side densify of a compact payload (numpy scatter) — the oracle
    the device path is tested against."""
    seq_len = int(batch["_seq_len"])
    lens = np.asarray(batch["uih_len"])
    b = len(lens)
    shared = np.zeros(b + 1, np.int64)
    shared[1:] = np.cumsum(lens, dtype=np.int64)
    j = np.arange(seq_len)
    out: HostBatch = {"uih_len": lens}
    for k, v in batch.items():
        if not k.startswith("_arena_"):
            continue
        trait = k[len("_arena_"):]
        offs = np.asarray(batch.get(f"_offsets_{trait}", shared))
        tl = np.minimum(np.diff(offs), seq_len)
        dense = np.zeros((b, seq_len), v.dtype)
        dense[j >= (seq_len - tl)[:, None]] = v
        out[f"uih_{trait}"] = dense
    out["uih_mask"] = j >= (seq_len - lens)[:, None]
    for k, v in batch.items():
        if k == "_seq_len" or k == "uih_len" or k.startswith(("_arena_",
                                                              "_offsets_")):
            continue
        out[k] = v
    return out


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array onto ``device``: on CUDA a pinned staging copy and a
    non-blocking H2D copy on the current stream (the caller orders the
    consumer after it); on the CPU the array itself, aliased."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class DeviceMaterializer:
    """Upload a compact jagged payload + run the fused kernel on the card.

    Stateless per batch except ``last_h2d_bytes`` (read by the prefetcher
    right after each call for the ``ClientStats.h2d_bytes`` counter). Runs on
    the caller's current CUDA stream."""

    def __init__(self, ts_trait: str = "timestamp", device: Any = "cuda"):
        self.ts_trait = ts_trait
        self.device = torch.device(device)
        self.last_h2d_bytes = 0

    def _put(self, x: np.ndarray) -> torch.Tensor:
        self.last_h2d_bytes += x.nbytes
        return to_device(x, self.device)

    def _group(self, batch: HostBatch, traits: List[str], offs: np.ndarray,
               seq_len: int) -> Dict[str, torch.Tensor]:
        """Materialize one shared-plan trait group with ONE kernel launch."""
        vals: Dict[str, np.ndarray] = {}
        ts_bases = None
        ts_col = -1
        for t in traits:
            col = np.asarray(batch[f"_arena_{t}"])
            if t == self.ts_trait and col.dtype == np.int64:
                deltas, bases64 = ts_delta_encode(col, offs)
                vals[t] = deltas
                # exact int64 bases: the kernel decodes exact timestamps
                ts_bases = self._put(bases64)
                ts_col = len(vals) - 1
            else:
                vals[t] = col
        arena, metas = pack_arena(vals)
        if (len(offs) and (offs[0] < 0 or offs[-1] > len(arena)
                           or (np.diff(offs) < 0).any())):
            # the kernel reads arena rows [offsets[b], offsets[b+1]) unchecked
            raise ValueError(f"payload offsets for {traits} are not a "
                             f"non-decreasing partition of {len(arena)} rows")
        dense, ts = fused_densify(self._put(arena),
                                  self._put(offs.astype(np.int32)),
                                  seq_len, ts_bases=ts_bases, ts_col=ts_col)
        return unpack_dense(dense, metas, ts, ts_col)

    def __call__(self, batch: HostBatch) -> Dict[str, torch.Tensor]:
        self.last_h2d_bytes = 0
        seq_len = int(batch["_seq_len"])
        lens_h = np.asarray(batch["uih_len"])
        b = len(lens_h)
        shared = np.zeros(b + 1, np.int64)
        shared[1:] = np.cumsum(lens_h, dtype=np.int64)
        traits = [k[len("_arena_"):] for k in batch if k.startswith("_arena_")]
        shared_group = [t for t in traits if f"_offsets_{t}" not in batch]
        dense_traits: Dict[str, torch.Tensor] = {}
        if shared_group:
            dense_traits.update(
                self._group(batch, shared_group, shared, seq_len))
        for t in traits:
            if f"_offsets_{t}" not in batch:
                continue
            # schema-evolution trait with its own jagged structure: its own
            # (1-column) kernel launch over its own offsets
            dense_traits.update(self._group(
                batch, [t], np.asarray(batch[f"_offsets_{t}"]), seq_len))
        lens = self._put(lens_h)
        j = torch.arange(seq_len, device=self.device)[None, :]
        mask = j >= (seq_len - lens[:, None])
        # key order mirrors JaggedFeatures.to_padded / densify_host exactly
        out: Dict[str, torch.Tensor] = {"uih_len": lens}
        for t in traits:
            out[f"uih_{t}"] = dense_traits[t]
        out["uih_mask"] = mask
        for k, v in batch.items():
            if k in ("_seq_len", "uih_len") or k.startswith(("_arena_",
                                                             "_offsets_")):
                continue
            out[k] = self._put(np.asarray(v))
        return out
