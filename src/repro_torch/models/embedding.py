"""Embedding tables, single-device lookups and MLPs in plain PyTorch.

Port of ``repro.models.embedding``. Tables are float32 parameters; a
lookup gathers rows first and casts the gathered rows to the compute dtype,
which equals the reference's cast-then-gather in the forward pass and never
copies a whole table (in the backward pass, repeated ids accumulate in
float32).

The row-sharded lookups (``bag_rowsharded``, ``lookup_rowsharded``,
``seq_rowsharded``) are rank-local programs over a ``DeviceMesh``: each
``model`` rank holds a contiguous block of the table's rows, gathers the
hits among its own rows, masks the rest, reduces a bag locally, and sums the
result over the ``model`` sub-mesh with a functional collective, after the
cast to the compute dtype, so the collective moves bf16. When the ids are
replicated over ``model`` (the train and serve cells: batches sharded over
the data axes) that sum is an all-reduce; when ``model`` is among the ids'
batch axes (the retrieval cells' candidates) each rank first all-gathers
the ids over ``model`` and the sum is a reduce-scatter back to its own rows.
Gradients follow ``torch.distributed._functional_collectives``' autograd: a
rank's loss is its part of the global loss, the all-reduce's backward is an
all-reduce, the reduce-scatter's an all-gather.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed._functional_collectives as funcol

Params = Dict[str, Any]


def init_table(gen: torch.Generator, vocab: int, dim: int,
               scale: float = 0.01, device="cuda") -> torch.Tensor:
    return torch.randn((vocab, dim), generator=gen, device=device).mul_(scale)


def lookup(table: torch.Tensor, ids: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``table[ids]`` in ``dtype``: any ids shape -> ids.shape + (D,)."""
    rows = table[ids]
    return rows if dtype is None else rows.to(dtype)


def row_partial(table: torch.Tensor, ids: torch.Tensor, mask, rank: int,
                 dt: torch.dtype) -> torch.Tensor:
    """This rank's part of ``table[ids]``: rows ``[rank*V_loc,
    (rank+1)*V_loc)`` of the global table are ``table``'s; other ids (and
    masked positions) give zeros."""
    v_loc = table.shape[0]
    local = ids - rank * v_loc
    hit = (local >= 0) & (local < v_loc)
    if mask is not None:
        hit = hit & mask
    emb = lookup(table, local.clamp(0, v_loc - 1), dt)
    return emb * hit[..., None].to(dt)


def _rowsharded(table, ids, mask, reduce_bag: bool, mesh, data_axes,
                model_axis, dtype) -> torch.Tensor:
    """The rank-local row-sharded lookup (module docstring): partial rows
    (summed over the last id axis when ``reduce_bag``), then the sum over
    the ``model`` sub-mesh."""
    dt = dtype or table.dtype
    group = mesh.get_group(model_axis)
    rank = mesh.get_local_rank(model_axis)
    scatter = model_axis in tuple(data_axes or ())
    if scatter:       # ids differ across model ranks: gather them first
        ids = funcol.all_gather_tensor(ids.contiguous(), 0, group)
        if mask is not None:
            mask = funcol.all_gather_tensor(mask.contiguous(), 0, group)
    part = row_partial(table, ids, mask, rank, dt)
    if reduce_bag:
        part = part.sum(dim=-2)
    if scatter:
        return funcol.reduce_scatter_tensor(part, "sum", 0, group)
    return funcol.all_reduce(part, "sum", group)


def bag_rowsharded(
    table: torch.Tensor,          # (V_loc, D): this model rank's rows
    ids: torch.Tensor,            # (B_loc, L) global ids
    mask: Optional[torch.Tensor],
    combiner: str,
    mesh,
    data_axes=("data",),
    model_axis: str = "model",
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Row(vocab)-sharded EmbeddingBag with the reduction BEFORE the
    collective: each model rank reduces the hits among its local rows and
    only the (B_loc, D) bag crosses the link, O(L) less traffic than
    summing the (B_loc, L, D) gather. ``combiner`` is sum or mean."""
    out = _rowsharded(table, ids, mask, True, mesh, data_axes, model_axis,
                      dtype)
    if combiner == "mean":
        denom = (ids.shape[-1] if mask is None
                 else torch.clamp(mask.sum(-1, keepdim=True), min=1))
        return out / torch.as_tensor(denom).to(out.dtype)
    if combiner != "sum":
        raise ValueError(combiner)
    return out


def lookup_rowsharded(table, ids, mesh, data_axes=("data",),
                      model_axis="model", dtype=None) -> torch.Tensor:
    """Single-id row-sharded lookup: (B,) ids -> (B, D)."""
    return _rowsharded(table, ids, None, False, mesh, data_axes, model_axis,
                       dtype)


def seq_rowsharded(table, ids, mesh, data_axes=("data",),
                   model_axis="model", dtype=None) -> torch.Tensor:
    """Per-position sequence lookup from a row-sharded table: (B, S) ids ->
    (B, S, D), partials summed over ``model`` in the compute dtype."""
    return _rowsharded(table, ids, None, False, mesh, data_axes, model_axis,
                       dtype)


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
