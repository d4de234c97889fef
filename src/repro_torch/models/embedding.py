"""Embedding tables, single-device lookups and MLPs in plain PyTorch.

Port of ``repro.models.embedding`` for one device. The row-sharded lookups
(``bag_rowsharded``, ``lookup_rowsharded``, ``seq_rowsharded``) come with the
multi-GPU slice. Tables are float32 parameters; a lookup gathers rows first
and casts the gathered rows to the compute dtype, which equals the
reference's cast-then-gather in the forward pass and never copies a whole
table (in the backward pass, repeated ids accumulate in float32).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

Params = Dict[str, Any]


def init_table(gen: torch.Generator, vocab: int, dim: int,
               scale: float = 0.01, device="cuda") -> torch.Tensor:
    return torch.randn((vocab, dim), generator=gen, device=device).mul_(scale)


def lookup(table: torch.Tensor, ids: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``table[ids]`` in ``dtype``: any ids shape -> ids.shape + (D,)."""
    rows = table[ids]
    return rows if dtype is None else rows.to(dtype)


def embedding_bag(
    table: torch.Tensor,          # (V, D)
    ids: torch.Tensor,            # (B, L) padded multi-hot ids
    mask: Optional[torch.Tensor] = None,   # (B, L) validity
    combiner: str = "sum",        # sum | mean | none
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """EmbeddingBag: gather + masked reduction over the bag axis."""
    dt = dtype or table.dtype
    emb = lookup(table, ids, dt)                    # (B, L, D)
    if mask is not None:
        emb = emb * mask[..., None].to(dt)
    if combiner == "none":
        return emb
    s = torch.sum(emb, dim=-2)
    if combiner == "sum":
        return s
    if combiner == "mean":
        denom = (torch.clamp(mask.sum(-1, keepdim=True), min=1).to(dt)
                 if mask is not None else torch.tensor(ids.shape[-1], dtype=dt))
        return s / denom
    raise ValueError(combiner)


def field_embeddings(tables: Dict[str, torch.Tensor], ids: torch.Tensor,
                     field_names: Sequence[str],
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-field single-hot lookup: (B, F) ids -> (B, F, D)."""
    cols = [lookup(tables[f], ids[:, i], dtype)
            for i, f in enumerate(field_names)]
    return torch.stack(cols, dim=1)


def mlp_init(gen: torch.Generator, dims: Sequence[int], scale=None,
             device="cuda") -> Params:
    out: Params = {}
    for i in range(len(dims) - 1):
        s = scale or 1.0 / math.sqrt(dims[i])
        out[f"w{i}"] = torch.randn((dims[i], dims[i + 1]), generator=gen,
                                   device=device).mul_(s)
    for i in range(len(dims) - 1):
        out[f"b{i}"] = torch.zeros((dims[i + 1],), device=device)
    return out


def mlp_apply(params: Params, x: torch.Tensor, n_layers: int,
              final_act: bool = False) -> torch.Tensor:
    dt = x.dtype
    for i in range(n_layers):
        x = x @ params[f"w{i}"].to(dt) + params[f"b{i}"].to(dt)
        if i < n_layers - 1 or final_act:
            x = torch.relu(x)
    return x
