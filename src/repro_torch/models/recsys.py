"""DLRM-UIH — the paper's flagship long-sequence ranking tenant, in PyTorch.

Port of the DLRM-UIH half of ``repro.models.recsys``: DLRM feature
interaction + a causal transformer encoder over an ultra-long UIH sequence
with target-aware pooling. Parameters keep the reference's tree layout
(``seq_blocks`` stacked on axis 0), so AdamW's ``ndim >= 2`` decay mask and
the checkpoint's leaf order match the reference. Attention scores and the
target-attention softmax run in float32, the rest in ``compute_dtype``.
``remat=True`` recomputes each encoder block in the backward pass
(``torch.utils.checkpoint``, non-reentrant).

The other tenants (two-tower, DCNv2, DIEN, BERT4Rec) come in later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.embedding import init_table, lookup, mlp_apply, mlp_init
from repro_torch.tree import to_parameter_dict, tree_map

Params = Dict[str, Any]


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    logits = logits.float()
    labels = labels.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def normalized_entropy(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """NE (paper §5.2, He et al. 2014): CE normalized by the entropy of the
    base rate — the paper's model-quality metric."""
    ce = bce_with_logits(logits, labels)
    p = torch.clamp(torch.mean(labels.float()), 1e-6, 1 - 1e-6)
    h = -(p * torch.log(p) + (1 - p) * torch.log(1 - p))
    return ce / h


@dataclasses.dataclass(frozen=True)
class DLRMUIHConfig:
    name: str = "dlrm-uih"
    seq_len: int = 2048
    d_seq: int = 128              # sequence-encoder width
    n_seq_layers: int = 2
    n_heads: int = 4
    n_dense: int = 13
    n_sparse: int = 4
    embed_dim: int = 64           # sparse field embedding dim
    item_vocab: int = 10_000_000
    field_vocab: int = 1_000_000
    top_mlp: Tuple[int, ...] = (512, 256)
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    q_chunk: int = 512


def _attn_config(cfg: DLRMUIHConfig) -> L.AttnConfig:
    return L.AttnConfig(d_model=cfg.d_seq, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_heads,
                        head_dim=cfg.d_seq // cfg.n_heads,
                        rope_theta=1e4, q_chunk=cfg.q_chunk)


def init_dlrm_uih(cfg: DLRMUIHConfig, seed: int = 0, device="cuda"
                  ) -> nn.ParameterDict:
    """Random float32 parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), in the reference's tree layout. torch and jax draw different
    numbers from one seed; tests load reference parameters through
    ``repro_torch.interop`` instead."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_seq
    attn_cfg = _attn_config(cfg)

    def block_init():
        return {
            "attn": L.init_gqa(gen, attn_cfg, device),
            "ffn": L.init_swiglu(gen, d, 4 * d, device),
            "ln1": torch.ones((d,), device=device),
            "ln2": torch.ones((d,), device=device),
        }

    blocks = [block_init() for _ in range(cfg.n_seq_layers)]
    n_inter = 3 + cfg.n_sparse   # user_seq, target, dense_proj + sparse fields
    d_pairs = n_inter * (n_inter - 1) // 2
    tree = {
        "item_table": init_table(gen, cfg.item_vocab, d, device=device),
        "action_table": init_table(gen, 16, d, device=device),
        "sparse_tables": init_table(gen, cfg.n_sparse * cfg.field_vocab,
                                    cfg.embed_dim, device=device),
        "dense_proj": mlp_init(gen, [cfg.n_dense, cfg.embed_dim],
                               device=device),
        # stacked on axis 0, as jax.vmap(block_init) lays them out
        "seq_blocks": tree_map(lambda *xs: torch.stack(xs), *blocks),
        "seq_ln": torch.ones((d,), device=device),
        "seq_proj": mlp_init(gen, [d, cfg.embed_dim], device=device),
        "target_proj": mlp_init(gen, [d, cfg.embed_dim], device=device),
        "top_mlp": mlp_init(gen, [d_pairs + cfg.embed_dim, *cfg.top_mlp, 1],
                            device=device),
    }
    return to_parameter_dict(tree)


def _encoder_block(h: torch.Tensor, block: Params, positions: torch.Tensor,
                   mask: torch.Tensor, attn_cfg: L.AttnConfig) -> torch.Tensor:
    hn = L.rms_norm(h, block["ln1"])
    h = h + L.gqa_attention(block["attn"], hn, positions, attn_cfg,
                            causal=True, kv_mask=mask)
    hn = L.rms_norm(h, block["ln2"])
    return h + L.swiglu(block["ffn"], hn)


def dlrm_uih_forward(params: Params, batch: Dict[str, torch.Tensor],
                     cfg: DLRMUIHConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    b, s = batch["uih_item_id"].shape
    attn_cfg = _attn_config(cfg)
    # --- UIH sequence encoder (causal, target-aware last token) ---
    h = (lookup(params["item_table"], batch["uih_item_id"], dt)
         + lookup(params["action_table"], batch["uih_action_type"], dt))
    mask = batch["uih_mask"]
    positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    for i in range(cfg.n_seq_layers):
        block = tree_map(lambda x: x[i], params["seq_blocks"])
        if cfg.remat:
            h = checkpoint(_encoder_block, h, block, positions, mask,
                           attn_cfg, use_reentrant=False)
        else:
            h = _encoder_block(h, block, positions, mask, attn_cfg)
    h = L.rms_norm(h, params["seq_ln"])

    # target-aware pooling: attention of the candidate over history (DIN-style)
    tgt = lookup(params["item_table"], batch["cand_item_id"], dt)   # (B, D)
    att = torch.einsum("bsd,bd->bs", h.float(), tgt.float())
    att = torch.softmax(
        torch.where(mask, att / math.sqrt(cfg.d_seq), L.MASK_VALUE), dim=-1
    ).to(dt)
    user_seq = torch.einsum("bs,bsd->bd", att, h)                    # (B, D)

    # --- DLRM-style feature interaction ---
    offsets = torch.arange(cfg.n_sparse, device=h.device) * cfg.field_vocab
    sparse = lookup(params["sparse_tables"], batch["sparse_ids"] + offsets, dt)
    dense = mlp_apply(params["dense_proj"], batch["dense"].to(dt), 1)
    feats = torch.stack(
        [
            mlp_apply(params["seq_proj"], user_seq, 1),
            mlp_apply(params["target_proj"], tgt, 1),
            dense,
        ]
        + [sparse[:, i] for i in range(cfg.n_sparse)],
        dim=1,
    )                                                               # (B, F, D)
    inter = torch.einsum("bfd,bgd->bfg", feats, feats)
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=h.device)
    pairs = inter[:, iu, ju]                                        # (B, F*(F-1)/2)
    z = torch.cat([pairs, dense], dim=-1)
    return mlp_apply(params["top_mlp"], z, len(cfg.top_mlp) + 1)[:, 0]


def dlrm_uih_loss(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: DLRMUIHConfig) -> torch.Tensor:
    return bce_with_logits(dlrm_uih_forward(params, batch, cfg),
                           batch["label"])


def dlrm_uih_prep(batch: Dict[str, torch.Tensor], cfg: DLRMUIHConfig
                  ) -> Dict[str, torch.Tensor]:
    """Model inputs from a feed batch, on the batch's device.

    The transforms of ``examples/train_seqrec.py:prep`` (vocab modulo, sparse
    ids from ``user_id`` and ``cand_item_id``, a dense vector from the
    history length), run after the device densify instead of on the host, so
    the feed keeps device materialization on. The two sparse sources cycle to
    fill ``cfg.n_sparse`` fields, and the dense feature repeats to
    ``cfg.n_dense``."""
    mask = batch["uih_mask"]
    seq_len = mask.shape[1]
    cand = batch["cand_item_id"]
    sources = (batch["user_id"], cand)
    sparse = torch.stack([sources[i % 2] % cfg.field_vocab
                          for i in range(cfg.n_sparse)], dim=1)
    return {
        "uih_item_id": (batch["uih_item_id"] % cfg.item_vocab).to(torch.int32),
        "uih_action_type": (batch["uih_action_type"] % 16).to(torch.int32),
        "uih_mask": mask,
        "cand_item_id": (cand % cfg.item_vocab).to(torch.int32),
        "sparse_ids": sparse.to(torch.int32),
        "dense": torch.stack([mask.sum(1)] * cfg.n_dense, dim=1).float()
        / seq_len,
        "label": batch["label_click"].float(),
    }
