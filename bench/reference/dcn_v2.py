"""Plain reference of DCN-v2 (arXiv:2008.13535): its parameters, its inputs
from a feed batch, and its loss.

A frozen copy of the port's single-card DCN-v2 (``models/recsys.py``): 26
sparse fields looked up in one table (field ``f`` owns rows ``[f * vocab,
(f + 1) * vocab)``) beside 13 dense features, full-rank cross layers
``x_{l+1} = x0 * (W x_l + b) + x_l``, a deep ReLU MLP over ``x0``, a linear
head over both, and a float32 binary cross-entropy. Products run in the
configuration's compute dtype on float32 parameters; every operand of a
product passes ``Precision.q``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from bench.reference.dlrm_uih import _bce, _mlp, _mlp_apply
from bench.reference.precision import Precision


def layout(cfg: dict):
    d = cfg["n_sparse"] * cfg["embed_dim"] + cfg["n_dense"]
    out = []
    for i in range(cfg["n_cross_layers"]):
        out.append(((f"cross_b{i}",), (d,), ("zeros",)))
        out.append(((f"cross_w{i}",), (d, d), ("normal", 1.0 / math.sqrt(d))))
    out.append((("embed",), (cfg["n_sparse"] * cfg["field_vocab"],
                             cfg["embed_dim"]), ("normal", 0.01)))
    out += _mlp("head", [cfg["mlp"][-1] + d, 1])
    out += _mlp("mlp", [d, *cfg["mlp"]])
    return sorted(out)


def prep(batch: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    """The model's inputs from a dense feed batch: sparse fields cycling
    the user and the candidate, the history's fill as the dense features,
    the click label."""
    mask = batch["uih_mask"]
    n_sparse, n_dense, fv = cfg["n_sparse"], cfg["n_dense"], cfg["field_vocab"]
    sources = (batch["user_id"], batch["cand_item_id"])
    sparse = torch.stack([sources[i % 2] % fv for i in range(n_sparse)],
                         dim=1).to(torch.int32)
    dense = torch.stack([mask.sum(1)] * n_dense, dim=1).float() / mask.shape[1]
    return {"sparse_ids": sparse, "dense": dense,
            "label": batch["label_click"].float()}


def logits(params, batch, cfg: dict, P: Precision) -> torch.Tensor:
    dt = P.dtype
    ids = batch["sparse_ids"]
    offs = torch.arange(cfg["n_sparse"], device=ids.device) * cfg["field_vocab"]
    emb = P.cast(params["embed"][ids + offs[None, :]])
    x0 = torch.cat([emb.reshape(ids.shape[0], -1), batch["dense"].to(dt)],
                   dim=-1)
    x = x0
    for i in range(cfg["n_cross_layers"]):
        xw = P.q(x) @ P.cast(params[f"cross_w{i}"]) + params[
            f"cross_b{i}"].to(dt)
        x = x0 * xw + x
    deep = _mlp_apply(params["mlp"], x0, len(cfg["mlp"]), P, final_act=True)
    return _mlp_apply(params["head"], torch.cat([x, deep], dim=-1), 1, P)[:, 0]


def loss(params, batch, cfg: dict, P: Precision) -> torch.Tensor:
    return _bce(logits(params, batch, cfg, P), batch["label"])


def meta_inputs(cfg: dict, rows: int, seq_len: int, device="meta"):
    """Model inputs of ``rows`` examples, shapes only."""
    return {
        "sparse_ids": torch.zeros((rows, cfg["n_sparse"]), dtype=torch.int32,
                                  device=device),
        "dense": torch.zeros((rows, cfg["n_dense"]), device=device),
        "label": torch.zeros((rows,), device=device),
    }
