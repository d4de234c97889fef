"""Refreshable item-tower candidate index + batched top-k (DESIGN.md §14.3).

Port of ``repro.serve.index``. The item side of two-tower retrieval is
embarrassingly precomputable: the item tower depends only on model
parameters, so serving keeps the full corpus's item embeddings as one dense
``[N, d]`` matrix on the device (in the compute dtype) and answers a request
batch with a single ``scores = U @ V.T`` and a top-k. ``refresh`` recomputes
the matrix from a (new) parameter set in chunks and swaps it atomically under
a lock: in-flight ``top_k`` calls finish against the matrix they grabbed, the
next batch sees the new one (the serving analogue of a generation flip, and
emitted as a ``serve_index_refresh`` event).

The top-k breaks ties as ``jax.lax.top_k`` does, the lower index first, and
orders floats by their total order (+0.0 above -0.0). ``torch.topk`` gives no
tie order on CUDA, and with bf16 scores over millions of candidates ties at
the k-th place are the normal case, so ``topk_lower_index_first`` ranks one
exact int64 key per candidate instead of the scores themselves.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import recsys as R

_LOW32 = 0xFFFFFFFF
_SIGN_FREE = 0x7FFFFFFF


@dataclasses.dataclass
class IndexStats:
    refreshes: int = 0      # full item-tower recomputes + atomic swaps
    queries: int = 0        # top_k batch calls answered
    scored_rows: int = 0    # user rows scored across all queries
    refresh_s: float = 0.0  # cumulative wall seconds spent refreshing


def _order_key(bits: torch.Tensor) -> torch.Tensor:
    """float32 bit patterns (as int64 of the int32 view) -> int64 keys whose
    order is the floats' total order; the map is its own inverse."""
    return torch.where(bits < 0, bits ^ _SIGN_FREE, bits)


def topk_lower_index_first(scores: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest float32 ``scores`` along
    the last axis, best first, equal scores in ascending index order: the
    order ``jax.lax.top_k`` gives.

    Each score becomes one int64 key: its order-preserving 32-bit image in
    the high half, the inverted column index in the low half. The keys are
    distinct, so ``torch.topk`` of them is exact and fully ordered, and the
    scores are decoded back from the kept keys bit for bit."""
    n = scores.shape[-1]
    if n > _LOW32:
        raise ValueError(f"topk_lower_index_first: {n} columns exceed 2^32")
    bits = scores.float().contiguous().view(torch.int32).to(torch.int64)
    keys = _order_key(bits).mul_(1 << 32)
    keys += _LOW32 - torch.arange(n, dtype=torch.int64, device=scores.device)
    top = torch.topk(keys, k, dim=-1, largest=True, sorted=True).values
    low = top & _LOW32
    idx = _LOW32 - low
    hi = _order_key(torch.div(top - low, 1 << 32, rounding_mode="floor"))
    return hi.to(torch.int32).view(torch.float32), idx


class CandidateIndex:
    """Dense item-embedding matrix over a fixed candidate corpus."""

    def __init__(self, cfg: R.TwoTowerConfig,
                 item_ids: Optional[np.ndarray] = None,
                 telemetry=None, batch_size: int = 8192,
                 device: Any = "cuda"):
        self.cfg = cfg
        self.item_ids = (np.arange(cfg.item_vocab, dtype=np.int64)
                         if item_ids is None
                         else np.asarray(item_ids, np.int64))
        self.telemetry = telemetry
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.version = 0            # bumped on every refresh; 0 = never built
        self.stats = IndexStats()
        self._lock = threading.Lock()
        self._emb: Optional[torch.Tensor] = None   # [N, d] L2-normalized rows

    def __len__(self) -> int:
        return len(self.item_ids)

    def refresh(self, params) -> int:
        """Recompute every candidate's item-tower embedding from ``params``
        in chunks of ``batch_size`` and atomically publish the new matrix.
        Returns the new version."""
        t0 = time.monotonic()
        n = len(self.item_ids)
        with torch.inference_mode():
            emb = torch.empty((n, self.cfg.embed_dim),
                              dtype=self.cfg.compute_dtype, device=self.device)
            for lo in range(0, n, self.batch_size):
                ids = torch.from_numpy(
                    self.item_ids[lo:lo + self.batch_size]).to(self.device)
                emb[lo:lo + len(ids)] = R.two_tower_item(params, ids, self.cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._lock:
            self._emb = emb
            self.version += 1
            version = self.version
            self.stats.refreshes += 1
            self.stats.refresh_s += time.monotonic() - t0
        if self.telemetry is not None:
            self.telemetry.events.emit(
                "serve_index_refresh", version=version,
                items=len(self.item_ids))
        return version

    def matrix(self) -> torch.Tensor:
        """The current ``[N, d]`` device matrix (no copy)."""
        with self._lock:
            emb = self._emb
        if emb is None:
            raise RuntimeError(
                "candidate index never refreshed; call refresh(params) first")
        return emb

    def embeddings(self) -> np.ndarray:
        """Host float32 copy of the current matrix (tests / report tooling)."""
        return self.matrix().float().cpu().numpy()

    def top_k(self, user_emb: np.ndarray,
              k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Score ``[B, d]`` user embeddings against the corpus; returns
        ``(item_ids [B, k], scores [B, k] float32)`` sorted best-first.
        The embeddings are cast to the compute dtype first, so float32
        copies of compute-dtype vectors score as the vectors themselves."""
        emb = self.matrix()
        k = min(k, len(self.item_ids))
        with torch.inference_mode():
            u = torch.from_numpy(np.asarray(user_emb, np.float32)).to(
                self.device).to(emb.dtype)
            scores, idx = topk_lower_index_first((u @ emb.T).float(), k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        self.stats.queries += 1
        self.stats.scored_rows += int(user_emb.shape[0])
        return self.item_ids[idx], scores
