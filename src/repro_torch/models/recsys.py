"""RecSys tenants in PyTorch: two-tower retrieval, DCN-v2, DIEN, BERT4Rec
and DLRM-UIH, and their candidate-scoring paths.

Port of ``repro.models.recsys``. Two-tower retrieval (YouTube
RecSys'19) encodes a user from their id and the mean bag of their history,
and an item from its id, into L2-normalized vectors scored by a dot product.
DCN-v2 crosses 26 sparse field embeddings and 13 dense features
(``x_{l+1} = x0 * (W x_l + b) + x_l``) beside a deep MLP. DIEN runs a GRU
interest extractor over the history and an AUGRU whose update gate the
candidate's attention scales. BERT4Rec is a bidirectional transformer
trained by a cloze objective (a sampled softmax at production vocabularies).
DLRM-UIH, the paper's flagship, is DLRM feature interaction + a causal
transformer encoder over an ultra-long UIH sequence with target-aware
pooling.

Parameters keep the reference's tree layout (``seq_blocks`` and ``blocks``
stacked on axis 0), so AdamW's ``ndim >= 2`` decay mask and the checkpoint's
leaf order match the reference. Attention scores, the target-attention
softmaxes and the losses run in float32, the rest in ``compute_dtype``.
``remat=True`` recomputes each DLRM-UIH encoder block in the backward pass
(``torch.utils.checkpoint``, non-reentrant). DIEN's two scans are Python
loops over the sequence, not ``torch.nn.GRU``: the reference's cell has its
bias on the input side only, an attention-gated update and a masked carry.
The ``*_score_candidates`` paths score one user against N candidates: the
shared encoder runs once and the per-candidate tail runs batched over N.

With ``cfg.mesh`` set (a ``DeviceMesh`` with a ``model`` axis), every
function is the rank-local program of a mesh of ranks: the big tables hold
this ``model`` rank's rows and the lookups take the row-sharded branch
(``models/embedding.py``); the batch arrives sharded over ``cfg.data_axes``
and ``_shard_batch_all`` narrows it to this rank's block of rows over
``data_axes + ("model",)`` for the encoder section; a forward pass gathers
its output back over ``model``; a loss is this rank's part of the global
loss (divided by the global row count), so gradients are partial sums that
``launch.steps`` reduces over the axes each parameter is replicated on. The
retrieval cells shard their candidates over every axis: their
``data_axes`` hold ``model`` too, the narrowing and the gather-back are
identities and the lookups gather ids over ``model`` and reduce-scatter the
rows. With ``mesh=None`` nothing of this runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import axes_group, axes_rank, axes_size
from repro_torch.models import layers as L
from repro_torch.models.embedding import (
    bag_rowsharded,
    embedding_bag,
    init_table,
    lookup,
    lookup_rowsharded,
    mlp_apply,
    mlp_init,
    seq_rowsharded,
)
from repro_torch.tree import to_parameter_dict, tree_map

Params = Dict[str, Any]


def _lookup(table, ids, cfg, dt):
    """Candidate/field lookup; the row-sharded branch on a mesh."""
    if cfg.mesh is not None:
        return lookup_rowsharded(table, ids, cfg.mesh, cfg.data_axes, dtype=dt)
    return lookup(table, ids, dt)


def _seq_lookup(table, ids, cfg, dt):
    """Per-position sequence lookup (B, S) -> (B, S, D)."""
    if cfg.mesh is not None:
        return seq_rowsharded(table, ids, cfg.mesh, cfg.data_axes, dtype=dt)
    return lookup(table, ids, dt)


def _bag(table, ids, mask, combiner, cfg, dt):
    if cfg.mesh is not None:
        return bag_rowsharded(table, ids, mask, combiner, cfg.mesh,
                              cfg.data_axes, dtype=dt)
    return embedding_bag(table, ids, mask, combiner, dt)


def _sharded_over_model(cfg) -> bool:
    """The batch already comes sharded over ``model`` (retrieval cells)."""
    return "model" in tuple(cfg.data_axes)


def _section_axes(cfg):
    axes = tuple(cfg.data_axes)
    return axes if "model" in axes else axes + ("model",)


def _shard_batch_all(x: torch.Tensor, cfg) -> torch.Tensor:
    """Recsys encoders have no model-parallel dims, so the ``model`` axis
    would otherwise idle while every ``model`` rank computes the same rows:
    keep this rank's block of a batch-leading tensor (sharded over the data
    axes, replicated over ``model``) for the encoder section. No
    communication; the other blocks' gradient is zero here and lives on the
    ranks that kept them."""
    if cfg.mesh is None or _sharded_over_model(cfg):
        return x
    n = axes_size(cfg.mesh, ("model",))
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows does not split over "
                         f"{n} model ranks")
    rows = x.shape[0] // n
    return x.narrow(0, cfg.mesh.get_local_rank("model") * rows, rows)


def _gather_batch(x: torch.Tensor, cfg) -> torch.Tensor:
    """The inverse of ``_shard_batch_all`` for an output: all-gather the
    row blocks over ``model``."""
    if cfg.mesh is None or _sharded_over_model(cfg):
        return x
    return funcol.all_gather_tensor(x.contiguous(), 0,
                                    cfg.mesh.get_group("model"))


def _global_mean(local_mean: torch.Tensor, cfg) -> torch.Tensor:
    """A mean over this rank's rows as its part of the mean over the global
    batch (equal blocks on every rank of the section)."""
    if cfg.mesh is None:
        return local_mean
    return local_mean / axes_size(cfg.mesh, _section_axes(cfg))


def _section_sum(x: torch.Tensor, cfg) -> torch.Tensor:
    """``x`` summed over the encoder section's ranks (no gradient)."""
    if cfg.mesh is None:
        return x
    return funcol.all_reduce(x.detach(), "sum",
                             axes_group(cfg.mesh, _section_axes(cfg)))


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


# ===========================================================================
# Two-tower retrieval
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    item_vocab: int = 10_000_000
    user_vocab: int = 20_000_000
    uih_len: int = 100
    temperature: float = 0.05
    compute_dtype: torch.dtype = torch.bfloat16
    mesh: Any = None              # row-sharded lookups when set
    data_axes: Tuple[str, ...] = ("data",)

    def param_count(self) -> int:
        d = self.embed_dim

        def mlp(dims):
            return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))

        return ((self.item_vocab + self.user_vocab) * d
                + mlp([2 * d, *self.tower_mlp]) + mlp([d, *self.tower_mlp]))


def init_two_tower(cfg: TwoTowerConfig, seed: int = 0, device="cuda"
                   ) -> nn.ParameterDict:
    """Random float32 parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), in the reference's tree layout."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.embed_dim
    return to_parameter_dict({
        "item_table": init_table(gen, cfg.item_vocab, d, device=device),
        "user_table": init_table(gen, cfg.user_vocab, d, device=device),
        # user tower input: user id emb + history bag emb
        "user_mlp": mlp_init(gen, [2 * d, *cfg.tower_mlp], device=device),
        # item tower input: item emb
        "item_mlp": mlp_init(gen, [d, *cfg.tower_mlp], device=device),
    })


def _l2_normalize(z: torch.Tensor) -> torch.Tensor:
    """``z / (||z|| + 1e-6)`` with the norm taken in float32 and cast back."""
    norm = torch.linalg.vector_norm(z.float(), dim=-1, keepdim=True)
    return z / (norm + 1e-6).to(z.dtype)


def _two_tower_user(params: Params, user_id: torch.Tensor,
                    uih_ids: torch.Tensor, uih_mask: torch.Tensor,
                    cfg: TwoTowerConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    u = _lookup(params["user_table"], user_id, cfg, dt)
    hist = _bag(params["item_table"], uih_ids, uih_mask, "mean", cfg, dt)
    z = _shard_batch_all(torch.cat([u, hist], dim=-1), cfg)
    z = mlp_apply(params["user_mlp"], z, len(cfg.tower_mlp))
    return _l2_normalize(z)


def _two_tower_item(params: Params, item_id: torch.Tensor,
                    cfg: TwoTowerConfig) -> torch.Tensor:
    z = _shard_batch_all(
        _lookup(params["item_table"], item_id, cfg, cfg.compute_dtype), cfg)
    return _l2_normalize(mlp_apply(params["item_mlp"], z, len(cfg.tower_mlp)))


def two_tower_user(params: Params, user_id: torch.Tensor,
                   uih_ids: torch.Tensor, uih_mask: torch.Tensor,
                   cfg: TwoTowerConfig) -> torch.Tensor:
    return _gather_batch(_two_tower_user(params, user_id, uih_ids, uih_mask,
                                         cfg), cfg)


def two_tower_item(params: Params, item_id: torch.Tensor,
                   cfg: TwoTowerConfig) -> torch.Tensor:
    return _gather_batch(_two_tower_item(params, item_id, cfg), cfg)


def two_tower_loss(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: TwoTowerConfig,
                   log_q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction. On a mesh every rank
    scores its rows against the candidates of the whole global batch
    (all-gathered over the encoder section)."""
    u = _two_tower_user(params, batch["user_id"], batch["uih_item_id"],
                        batch["uih_mask"], cfg)
    v = _two_tower_item(params, batch["cand_item_id"], cfg)
    first = 0                                 # this rank's first global row
    if cfg.mesh is not None:
        axes = _section_axes(cfg)
        group = axes_group(cfg.mesh, axes)
        first = axes_rank(cfg.mesh, axes) * u.shape[0]
        v = funcol.all_gather_tensor(v.contiguous(), 0, group)
        if log_q is not None:
            log_q = funcol.all_gather_tensor(
                _shard_batch_all(log_q, cfg).contiguous(), 0, group)
    logits = (u @ v.T).float() / cfg.temperature                # (B, B)
    if log_q is not None:  # correct for in-batch sampling bias
        logits = logits - log_q[None, :]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.diagonal(logits, offset=first)
    return _global_mean(torch.mean(logz - gold), cfg)


def two_tower_score_candidates(params: Params, batch: Dict[str, torch.Tensor],
                               cand_ids: torch.Tensor, cfg: TwoTowerConfig
                               ) -> torch.Tensor:
    """retrieval_cand: one query vs N candidates as a single batched dot."""
    u = two_tower_user(params, batch["user_id"], batch["uih_item_id"],
                       batch["uih_mask"], cfg)                 # (1, d)
    v = two_tower_item(params, cand_ids, cfg)                  # (N, d)
    return (u @ v.T) / cfg.temperature                         # (1, N)


# ===========================================================================
# DCN-v2
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class DCNv2Config:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: Tuple[int, ...] = (1024, 1024, 512)
    field_vocab: int = 1_000_000
    compute_dtype: torch.dtype = torch.bfloat16
    mesh: Any = None              # row-sharded lookups when set
    data_axes: Tuple[str, ...] = ("data",)

    @property
    def d_interact(self) -> int:
        return self.n_sparse * self.embed_dim + self.n_dense


def init_dcn_v2(cfg: DCNv2Config, seed: int = 0, device="cuda"
                ) -> nn.ParameterDict:
    """Random float32 parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), in the reference's tree layout."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_interact
    tree = {
        # one big table: field f uses rows [f*vocab, (f+1)*vocab)
        "embed": init_table(gen, cfg.n_sparse * cfg.field_vocab,
                            cfg.embed_dim, device=device),
        "mlp": mlp_init(gen, [d, *cfg.mlp], device=device),
        "head": mlp_init(gen, [cfg.mlp[-1] + d, 1], device=device),
    }
    for i in range(cfg.n_cross_layers):
        tree[f"cross_w{i}"] = L._init(gen, (d, d), device=device)
        tree[f"cross_b{i}"] = torch.zeros((d,), device=device)
    return to_parameter_dict(tree)


def _dcn_v2_logits(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: DCNv2Config) -> torch.Tensor:
    dt = cfg.compute_dtype
    ids = batch["sparse_ids"]                                  # (B, F)
    offsets = torch.arange(cfg.n_sparse, device=ids.device) * cfg.field_vocab
    emb = _seq_lookup(params["embed"], ids + offsets[None, :], cfg,
                      dt)                                      # (B, F, D)
    x0 = _shard_batch_all(torch.cat(
        [emb.reshape(ids.shape[0], -1), batch["dense"].to(dt)], dim=-1), cfg)
    x = x0
    for i in range(cfg.n_cross_layers):   # x_{l+1} = x0*(W x_l + b) + x_l
        xw = x @ params[f"cross_w{i}"].to(dt) + params[f"cross_b{i}"].to(dt)
        x = x0 * xw + x
    deep = mlp_apply(params["mlp"], x0, len(cfg.mlp), final_act=True)
    z = torch.cat([x, deep], dim=-1)
    return mlp_apply(params["head"], z, 1)[:, 0]


def dcn_v2_forward(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: DCNv2Config) -> torch.Tensor:
    return _gather_batch(_dcn_v2_logits(params, batch, cfg), cfg)


def dcn_v2_loss(params: Params, batch: Dict[str, torch.Tensor],
                cfg: DCNv2Config) -> torch.Tensor:
    return _global_mean(bce_with_logits(
        _dcn_v2_logits(params, batch, cfg),
        _shard_batch_all(batch["label"], cfg)), cfg)


# ===========================================================================
# DIEN (GRU interest extractor + AUGRU interest evolution)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: Tuple[int, ...] = (200, 80)
    item_vocab: int = 1_000_000
    cat_vocab: int = 10_000
    compute_dtype: torch.dtype = torch.bfloat16
    mesh: Any = None              # row-sharded lookups when set
    data_axes: Tuple[str, ...] = ("data",)

    @property
    def d_in(self) -> int:
        return 2 * self.embed_dim  # item emb ++ category emb


def _gru_init(gen: torch.Generator, d_in: int, d_h: int, device) -> Params:
    return {
        "wx": L._init(gen, (d_in, 3 * d_h), device=device),
        "wh": L._init(gen, (d_h, 3 * d_h), device=device),
        "b": torch.zeros((3 * d_h,), device=device),
    }


def _gru_cell(p: Params, h: torch.Tensor, x: torch.Tensor,
              att: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GRU step, gates r, z, n with the bias on the input side only;
    ``att`` (B, 1) turns it into AUGRU (attention-gated update). ``x`` may
    be one row broadcast over the batch of ``h``."""
    dt = x.dtype
    gx = x @ p["wx"].to(dt) + p["b"].to(dt)
    gh = h @ p["wh"].to(dt)
    rx, zx, nx = torch.chunk(gx, 3, dim=-1)
    rh, zh, nh = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    if att is not None:
        z = z * att  # AUGRU: scale update gate by attention weight
    return (1 - z) * h + z * n


def init_dien(cfg: DIENConfig, seed: int = 0, device="cuda"
              ) -> nn.ParameterDict:
    """Random float32 parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), in the reference's tree layout."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return to_parameter_dict({
        "item_table": init_table(gen, cfg.item_vocab, cfg.embed_dim,
                                 device=device),
        "cat_table": init_table(gen, cfg.cat_vocab, cfg.embed_dim,
                                device=device),
        "gru1": _gru_init(gen, cfg.d_in, cfg.gru_dim, device),
        "augru": _gru_init(gen, cfg.gru_dim, cfg.gru_dim, device),
        "att_w": L._init(gen, (cfg.gru_dim, cfg.d_in), device=device),
        "mlp": mlp_init(gen, [cfg.gru_dim + 2 * cfg.d_in, *cfg.mlp, 1],
                        device=device),
    })


def _dien_history(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: DIENConfig):
    """The history's embeddings (B, S, 2D), its validity (B, S) and the
    mask in the compute dtype, narrowed to the encoder section's rows."""
    dt = cfg.compute_dtype
    mask = _shard_batch_all(batch["uih_mask"], cfg).to(dt)
    e = torch.cat(
        [_seq_lookup(params["item_table"], batch["uih_item_id"], cfg, dt),
         _seq_lookup(params["cat_table"], batch["uih_category"], cfg, dt)],
        dim=-1)
    return _shard_batch_all(e, cfg), mask > 0, mask


def _dien_target(params: Params, item_ids: torch.Tensor,
                 cat_ids: torch.Tensor, cfg: DIENConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    return _shard_batch_all(torch.cat(
        [_lookup(params["item_table"], item_ids, cfg, dt),
         _lookup(params["cat_table"], cat_ids, cfg, dt)], dim=-1), cfg)


def _interest_states(p: Params, e: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """GRU-1 over the history: every step's state (B, S, H). A masked step
    carries h through unchanged."""
    h = e.new_zeros((e.shape[0], p["wh"].shape[0]))
    states = []
    for t in range(e.shape[1]):
        h = torch.where(valid[:, t, None], _gru_cell(p, h, e[:, t]), h)
        states.append(h)
    return torch.stack(states, dim=1)


def _attention(logits: torch.Tensor, valid: torch.Tensor, dt: torch.dtype
               ) -> torch.Tensor:
    """Softmax over the valid positions of float32 ``logits``, in ``dt``."""
    return torch.softmax(torch.where(valid, logits, L.MASK_VALUE),
                         dim=-1).to(dt)


def _augru_final(p: Params, interests: torch.Tensor, att: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """AUGRU over the interest states: the final state (N, H) for N rows of
    attention ``att`` (N, S). ``interests`` and ``valid`` have N rows, or one
    row that every attention row shares."""
    h = interests.new_zeros((att.shape[0], interests.shape[-1]))
    for t in range(interests.shape[1]):
        h_new = _gru_cell(p, h, interests[:, t], att[:, t, None])
        h = torch.where(valid[:, t, None], h_new, h)
    return h


def _dien_head(params: Params, final: torch.Tensor, tgt: torch.Tensor,
               hist_sum: torch.Tensor, cfg: DIENConfig) -> torch.Tensor:
    z = torch.cat([final, tgt, hist_sum], dim=-1)
    return mlp_apply(params["mlp"], z, len(cfg.mlp) + 1)[:, 0]


def _dien_logits(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: DIENConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    e, valid, mask = _dien_history(params, batch, cfg)         # (B, S, 2D)
    tgt = _dien_target(params, batch["cand_item_id"],
                       batch["cand_category"], cfg)            # (B, 2D)
    interests = _interest_states(params["gru1"], e, valid)     # (B, S, H)
    # attention of target vs interest states: einsum("bsh,hd,bd->bs") with
    # float32 accumulation (bf16 operands are exact in float32)
    proj = interests.float() @ params["att_w"].to(dt).float()  # (B, S, 2D)
    att = _attention(torch.einsum("bsd,bd->bs", proj, tgt.float()), valid,
                     dt)                                       # (B, S)
    final = _augru_final(params["augru"], interests, att, valid)
    hist_sum = torch.sum(e * mask[..., None], dim=1)
    return _dien_head(params, final, tgt, hist_sum, cfg)


def dien_forward(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: DIENConfig) -> torch.Tensor:
    return _gather_batch(_dien_logits(params, batch, cfg), cfg)


def dien_loss(params: Params, batch: Dict[str, torch.Tensor],
              cfg: DIENConfig) -> torch.Tensor:
    return _global_mean(bce_with_logits(
        _dien_logits(params, batch, cfg),
        _shard_batch_all(batch["label"], cfg)), cfg)


# ===========================================================================
# BERT4Rec
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class BERT4RecConfig:
    name: str = "bert4rec"
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    item_vocab: int = 1_000_000
    mask_token: int = 0
    compute_dtype: torch.dtype = torch.bfloat16
    mesh: Any = None              # row-sharded lookups when set
    data_axes: Tuple[str, ...] = ("data",)
    loss_chunk: int = 0   # 0 = no chunking


def _bert4rec_attn_config(cfg: BERT4RecConfig, scores_f32: bool = True
                          ) -> L.AttnConfig:
    return L.AttnConfig(d_model=cfg.embed_dim, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_heads,
                        head_dim=cfg.embed_dim // cfg.n_heads,
                        rope_theta=1e4, q_chunk=1 << 30,
                        scores_f32=scores_f32)


def _init_blocks(gen: torch.Generator, attn_cfg: L.AttnConfig, n: int,
                 device) -> Params:
    """``n`` transformer blocks stacked on axis 0, as
    ``jax.vmap(block_init)`` lays them out."""
    d = attn_cfg.d_model

    def block_init():
        return {
            "attn": L.init_gqa(gen, attn_cfg, device),
            "ffn": L.init_swiglu(gen, d, 4 * d, device),
            "ln1": torch.ones((d,), device=device),
            "ln2": torch.ones((d,), device=device),
        }

    return L.stack_blocks(n, block_init)


def init_bert4rec(cfg: BERT4RecConfig, seed: int = 0, device="cuda"
                  ) -> nn.ParameterDict:
    """Random float32 parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), in the reference's tree layout."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.embed_dim
    return to_parameter_dict({
        "item_table": init_table(gen, cfg.item_vocab, d, device=device),
        "pos_table": init_table(gen, cfg.seq_len, d, device=device),
        "blocks": _init_blocks(gen, _bert4rec_attn_config(cfg), cfg.n_blocks,
                               device),
        "final_ln": torch.ones((d,), device=device),
    })


def bert4rec_encode(params: Params, ids: torch.Tensor, mask: torch.Tensor,
                    cfg: BERT4RecConfig) -> torch.Tensor:
    """Bidirectional encoder: (B, S) ids -> (B, S, D), narrowed to the
    encoder section's rows. The positional table is added to every
    position, so S must equal ``cfg.seq_len``. On a mesh the attention
    scores stay in the compute dtype, as the reference's
    ``scores_f32=(cfg.mesh is None)``."""
    return _bert4rec_encode(params, ids, mask, cfg, cfg.mesh is None)


def _bert4rec_encode(params: Params, ids: torch.Tensor, mask: torch.Tensor,
                     cfg: BERT4RecConfig, scores_f32: bool) -> torch.Tensor:
    dt = cfg.compute_dtype
    attn_cfg = _bert4rec_attn_config(cfg, scores_f32)
    h = (_seq_lookup(params["item_table"], ids, cfg, dt)
         + params["pos_table"].to(dt)[None])
    h = _shard_batch_all(h, cfg)
    mask = _shard_batch_all(mask, cfg)
    b, s = h.shape[:2]
    positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    for i in range(cfg.n_blocks):
        block = tree_map(lambda x: x[i], params["blocks"])
        h = _encoder_block(h, block, positions, mask, attn_cfg, causal=False)
    return L.rms_norm(h, params["final_ln"])


def bert4rec_loss(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: BERT4RecConfig) -> torch.Tensor:
    """Cloze objective: predict items at masked positions.

    At production vocab (1e6 items) a full softmax over (B, S, V) is
    infeasible; when the batch carries shared sampled negatives (``neg_ids``)
    the loss is a sampled softmax over ``[gold | negatives]``, in chunks of
    ``cfg.loss_chunk`` positions when that divides S. On a mesh the
    negatives are shared by every rank and the full softmax is not offered
    (its vocabulary would be row-sharded)."""
    ids = batch["uih_item_id"]
    mask_pos = batch["mask_pos"].to(torch.bool)               # (B, S) to predict
    inputs = torch.where(mask_pos, cfg.mask_token, ids)
    h = bert4rec_encode(params, inputs, batch["uih_mask"], cfg)  # (B, S, D)
    mask_pos_s = _shard_batch_all(mask_pos, cfg)
    n_pred = torch.clamp(_section_sum(mask_pos_s.sum(), cfg), min=1)
    neg_ids = batch.get("neg_ids")
    if neg_ids is None and cfg.mesh is not None:
        raise ValueError("bert4rec_loss on a mesh needs batch['neg_ids']")
    if neg_ids is None:                                       # full softmax
        logits = (h @ params["item_table"].to(h.dtype).T).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ids[..., None].long())[..., 0]
        return torch.sum((logz - gold) * mask_pos) / n_pred

    neg_emb = _lookup(params["item_table"], neg_ids, cfg, h.dtype)  # (N, D)
    gold_emb = _shard_batch_all(
        _seq_lookup(params["item_table"], ids, cfg, h.dtype), cfg)  # (B,S,D)
    gold_logit = torch.sum(h * gold_emb, dim=-1).float()      # (B, S)
    s = h.shape[1]
    lc = cfg.loss_chunk if cfg.loss_chunk and s % cfg.loss_chunk == 0 else s
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, lc):
        hi, gi = h[:, lo:lo + lc], gold_logit[:, lo:lo + lc]
        neg_logits = (hi @ neg_emb.T).float()                 # (B, lc, N)
        # sampled softmax over [gold | negatives]; max per (b, s) position
        m = torch.maximum(neg_logits.amax(dim=-1), gi)
        z = torch.exp(gi - m) + torch.exp(neg_logits - m[..., None]).sum(-1)
        total = total + torch.sum((m + torch.log(z) - gi)
                                  * mask_pos_s[:, lo:lo + lc])
    return total / n_pred


def bert4rec_forward(params: Params, batch: Dict[str, torch.Tensor],
                     cfg: BERT4RecConfig) -> torch.Tensor:
    """Serving: score the candidate item for the next position."""
    h = bert4rec_encode(params, batch["uih_item_id"], batch["uih_mask"], cfg)
    user_repr = h[:, -1]                                      # (B, D)
    cand = _shard_batch_all(
        _lookup(params["item_table"], batch["cand_item_id"], cfg, h.dtype),
        cfg)
    return _gather_batch(torch.sum(user_repr * cand, dim=-1), cfg)


# ===========================================================================
# DLRM-UIH
# ===========================================================================

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
    mesh: Any = None              # row-sharded lookups when set
    data_axes: Tuple[str, ...] = ("data",)
    remat: bool = True
    q_chunk: int = 512


def _attn_config(cfg: DLRMUIHConfig, scores_f32: bool = True
                 ) -> L.AttnConfig:
    return L.AttnConfig(d_model=cfg.d_seq, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_heads,
                        head_dim=cfg.d_seq // cfg.n_heads,
                        rope_theta=1e4, q_chunk=cfg.q_chunk,
                        scores_f32=scores_f32)


def init_dlrm_uih(cfg: DLRMUIHConfig, seed: int = 0, device="cuda"
                  ) -> nn.ParameterDict:
    """Random float32 parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), in the reference's tree layout. torch and jax draw different
    numbers from one seed; tests load reference parameters through
    ``repro_torch.interop`` instead."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_seq
    blocks = _init_blocks(gen, _attn_config(cfg), cfg.n_seq_layers, device)
    n_inter = 3 + cfg.n_sparse   # user_seq, target, dense_proj + sparse fields
    d_pairs = n_inter * (n_inter - 1) // 2
    tree = {
        "item_table": init_table(gen, cfg.item_vocab, d, device=device),
        "action_table": init_table(gen, 16, d, device=device),
        "sparse_tables": init_table(gen, cfg.n_sparse * cfg.field_vocab,
                                    cfg.embed_dim, device=device),
        "dense_proj": mlp_init(gen, [cfg.n_dense, cfg.embed_dim],
                               device=device),
        "seq_blocks": blocks,
        "seq_ln": torch.ones((d,), device=device),
        "seq_proj": mlp_init(gen, [d, cfg.embed_dim], device=device),
        "target_proj": mlp_init(gen, [d, cfg.embed_dim], device=device),
        "top_mlp": mlp_init(gen, [d_pairs + cfg.embed_dim, *cfg.top_mlp, 1],
                            device=device),
    }
    return to_parameter_dict(tree)


def _encoder_block(h: torch.Tensor, block: Params, positions: torch.Tensor,
                   mask: torch.Tensor, attn_cfg: L.AttnConfig,
                   causal: bool = True) -> torch.Tensor:
    hn = L.rms_norm(h, block["ln1"])
    h = h + L.gqa_attention(block["attn"], hn, positions, attn_cfg,
                            causal=causal, kv_mask=mask)
    hn = L.rms_norm(h, block["ln2"])
    return h + L.swiglu(block["ffn"], hn)


def _dlrm_uih_sequence(params: Params, batch: Dict[str, torch.Tensor],
                       cfg: DLRMUIHConfig, remat: bool, scores_f32: bool):
    """The UIH sequence encoder (causal): (B, S) history -> (B, S, D), and
    the history's mask, both narrowed to the encoder section's rows."""
    dt = cfg.compute_dtype
    attn_cfg = _attn_config(cfg, scores_f32)
    h = (_seq_lookup(params["item_table"], batch["uih_item_id"], cfg, dt)
         + lookup(params["action_table"], batch["uih_action_type"], dt))
    h = _shard_batch_all(h, cfg)
    mask = _shard_batch_all(batch["uih_mask"], cfg)
    b, s = h.shape[:2]
    positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    for i in range(cfg.n_seq_layers):
        block = tree_map(lambda x: x[i], params["seq_blocks"])
        if remat:
            h = checkpoint(_encoder_block, h, block, positions, mask,
                           attn_cfg, use_reentrant=False)
        else:
            h = _encoder_block(h, block, positions, mask, attn_cfg)
    return L.rms_norm(h, params["seq_ln"]), mask


def _dlrm_uih_top(params: Params, user_seq: torch.Tensor, tgt: torch.Tensor,
                  sparse: torch.Tensor, dense: torch.Tensor,
                  cfg: DLRMUIHConfig) -> torch.Tensor:
    """DLRM-style feature interaction and the top MLP over N rows: pooled
    history, target, dense projection (N, E) and sparse fields (N, F, E)."""
    feats = torch.stack(
        [
            mlp_apply(params["seq_proj"], user_seq, 1),
            mlp_apply(params["target_proj"], tgt, 1),
            dense,
        ]
        + [sparse[:, i] for i in range(cfg.n_sparse)],
        dim=1,
    )                                                               # (N, F, D)
    inter = torch.einsum("bfd,bgd->bfg", feats, feats)
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
    pairs = inter[:, iu, ju]                                        # (N, F*(F-1)/2)
    z = torch.cat([pairs, dense], dim=-1)
    return mlp_apply(params["top_mlp"], z, len(cfg.top_mlp) + 1)[:, 0]


def _dlrm_uih_fields(params: Params, batch: Dict[str, torch.Tensor],
                     cfg: DLRMUIHConfig):
    """The sparse field embeddings (B, F, E) and the dense projection
    (B, E), narrowed to the encoder section's rows."""
    dt = cfg.compute_dtype
    ids = batch["sparse_ids"]
    offsets = torch.arange(cfg.n_sparse, device=ids.device) * cfg.field_vocab
    sparse = _shard_batch_all(
        _seq_lookup(params["sparse_tables"], ids + offsets, cfg, dt), cfg)
    dense = mlp_apply(params["dense_proj"],
                      _shard_batch_all(batch["dense"], cfg).to(dt), 1)
    return sparse, dense


def _dlrm_uih_logits(params: Params, batch: Dict[str, torch.Tensor],
                     cfg: DLRMUIHConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    # on a mesh the scores stay in the compute dtype, as the reference's
    # scores_f32=(cfg.mesh is None)
    h, mask = _dlrm_uih_sequence(params, batch, cfg, cfg.remat,
                                 cfg.mesh is None)                  # (B, S, D)
    # target-aware pooling: attention of the candidate over history (DIN-style)
    tgt = _shard_batch_all(_lookup(params["item_table"],
                                   batch["cand_item_id"], cfg, dt),
                           cfg)                                     # (B, D)
    att = torch.einsum("bsd,bd->bs", h.float(), tgt.float())
    att = _attention(att / math.sqrt(cfg.d_seq), mask, dt)
    user_seq = torch.einsum("bs,bsd->bd", att, h)                    # (B, D)
    sparse, dense = _dlrm_uih_fields(params, batch, cfg)
    return _dlrm_uih_top(params, user_seq, tgt, sparse, dense, cfg)


def dlrm_uih_forward(params: Params, batch: Dict[str, torch.Tensor],
                     cfg: DLRMUIHConfig) -> torch.Tensor:
    return _gather_batch(_dlrm_uih_logits(params, batch, cfg), cfg)


def dlrm_uih_loss(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: DLRMUIHConfig) -> torch.Tensor:
    return _global_mean(bce_with_logits(
        _dlrm_uih_logits(params, batch, cfg),
        _shard_batch_all(batch["label"], cfg)), cfg)


# ===========================================================================
# retrieval_cand paths: 1 query scored against N candidates (no python loops
# over N)
# ===========================================================================

def bert4rec_score_candidates(params: Params, batch: Dict[str, torch.Tensor],
                              cand_ids: torch.Tensor, cfg: BERT4RecConfig
                              ) -> torch.Tensor:
    h = _bert4rec_encode(params, batch["uih_item_id"], batch["uih_mask"],
                         cfg, scores_f32=True)
    user_repr = h[:, -1]                                       # (1, D)
    cand = _lookup(params["item_table"], cand_ids, cfg, h.dtype)   # (N, D)
    return user_repr @ cand.T                                  # (1, N)


def dcn_v2_score_candidates(params: Params, batch: Dict[str, torch.Tensor],
                            cand_ids: torch.Tensor, cfg: DCNv2Config
                            ) -> torch.Tensor:
    """Offline bulk scoring: broadcast the user context across N candidates;
    sparse field 0 is the candidate item."""
    n = cand_ids.shape[0]
    sparse = batch["sparse_ids"].expand(n, cfg.n_sparse).clone()
    sparse[:, 0] = cand_ids
    dense = batch["dense"].expand(n, cfg.n_dense)
    return dcn_v2_forward(params, {"sparse_ids": sparse, "dense": dense}, cfg)


def dien_score_candidates(params: Params, batch: Dict[str, torch.Tensor],
                          cand_ids: torch.Tensor, cand_cats: torch.Tensor,
                          cfg: DIENConfig) -> torch.Tensor:
    """GRU-1 interest extraction runs ONCE; target-aware attention + AUGRU run
    batched over the N candidates."""
    dt = cfg.compute_dtype
    e, valid, mask = _dien_history(params, batch, cfg)         # (1, S, 2D)
    interests = _interest_states(params["gru1"], e, valid)     # (1, S, H)
    tgt = _dien_target(params, cand_ids, cand_cats, cfg)       # (N, 2D)
    proj = interests[0].float() @ params["att_w"].to(dt).float()   # (S, 2D)
    att = _attention(tgt.float() @ proj.T, valid, dt)          # (N, S)
    final = _augru_final(params["augru"], interests, att, valid)   # (N, H)
    hist_sum = torch.sum(e * mask[..., None], dim=1)           # (1, 2D)
    return _dien_head(params, final, tgt,
                      hist_sum.expand(cand_ids.shape[0], -1), cfg)


def dlrm_uih_score_candidates(params: Params, batch: Dict[str, torch.Tensor],
                              cand_ids: torch.Tensor, cfg: DLRMUIHConfig
                              ) -> torch.Tensor:
    """Sequence encoder runs ONCE; target-aware pooling + interaction + top
    MLP run batched over N candidates. The pooling's logits are (N, S)
    float32: 8.2 GB at N=1e6, S=2048."""
    dt = cfg.compute_dtype
    if batch["uih_item_id"].shape[0] != 1:
        raise ValueError("dlrm_uih_score_candidates scores one user")
    h = _dlrm_uih_sequence(params, batch, cfg, remat=False,
                           scores_f32=True)[0][0]                   # (S, D)
    n = cand_ids.shape[0]
    tgt = _lookup(params["item_table"], cand_ids, cfg, dt)          # (N, D)
    att = tgt.float() @ h.float().T                                  # (N, S)
    att = _attention(att / math.sqrt(cfg.d_seq), batch["uih_mask"], dt)
    user_seq = att @ h                                               # (N, D)
    sparse, dense = _dlrm_uih_fields(params, batch, cfg)
    return _dlrm_uih_top(params, user_seq, tgt,
                         sparse.expand(n, cfg.n_sparse, cfg.embed_dim),
                         dense.expand(n, cfg.embed_dim), cfg)


# ===========================================================================
# Device-side preps: a feed batch -> a tenant's model inputs
# ===========================================================================
#
# Glue between the feed and the models, not model features: each runs the
# transforms of ``examples/train_seqrec.py:prep`` (vocab modulo, model input
# names) on the batch's device after the device densify, so the feed keeps
# device materialization on (a ``prep_fn`` on the feed would switch it off).

MASK_RATE = 0.2      # BERT4Rec's cloze rate (repro/launch/sampling.py)
N_NEGATIVES = 1024   # BERT4Rec's shared sampled negatives (repro/launch/steps.py)


def _sparse_dense(batch: Dict[str, torch.Tensor], n_sparse: int,
                  n_dense: int, field_vocab: int):
    """Sparse ids cycling ``user_id`` and ``cand_item_id`` over ``n_sparse``
    fields, and the history's fill repeated over ``n_dense`` features."""
    mask = batch["uih_mask"]
    sources = (batch["user_id"], batch["cand_item_id"])
    sparse = torch.stack([sources[i % 2] % field_vocab
                          for i in range(n_sparse)], dim=1)
    dense = torch.stack([mask.sum(1)] * n_dense, dim=1).float() / mask.shape[1]
    return sparse.to(torch.int32), dense


def dlrm_uih_prep(batch: Dict[str, torch.Tensor], cfg: DLRMUIHConfig
                  ) -> Dict[str, torch.Tensor]:
    """DLRM-UIH's inputs from a feed batch, on the batch's device (glue)."""
    sparse, dense = _sparse_dense(batch, cfg.n_sparse, cfg.n_dense,
                                  cfg.field_vocab)
    return {
        "uih_item_id": (batch["uih_item_id"] % cfg.item_vocab).to(torch.int32),
        "uih_action_type": (batch["uih_action_type"] % 16).to(torch.int32),
        "uih_mask": batch["uih_mask"],
        "cand_item_id": (batch["cand_item_id"] % cfg.item_vocab).to(
            torch.int32),
        "sparse_ids": sparse,
        "dense": dense,
        "label": batch["label_click"].float(),
    }


def dcn_v2_prep(batch: Dict[str, torch.Tensor], cfg: DCNv2Config
                ) -> Dict[str, torch.Tensor]:
    """DCN-v2's inputs from a feed batch, on the batch's device (glue): it
    reads only the scalars and the history's length."""
    sparse, dense = _sparse_dense(batch, cfg.n_sparse, cfg.n_dense,
                                  cfg.field_vocab)
    return {"sparse_ids": sparse, "dense": dense,
            "label": batch["label_click"].float()}


def dien_prep(batch: Dict[str, torch.Tensor], cfg: DIENConfig
              ) -> Dict[str, torch.Tensor]:
    """DIEN's inputs from a feed batch, on the batch's device (glue)."""
    i32 = torch.int32
    return {
        "uih_item_id": (batch["uih_item_id"] % cfg.item_vocab).to(i32),
        "uih_category": (batch["uih_category"] % cfg.cat_vocab).to(i32),
        "uih_mask": batch["uih_mask"],
        "cand_item_id": (batch["cand_item_id"] % cfg.item_vocab).to(i32),
        "cand_category": (batch["cand_category"] % cfg.cat_vocab).to(i32),
        "label": batch["label_click"].float(),
    }


def bert4rec_prep(batch: Dict[str, torch.Tensor], cfg: BERT4RecConfig,
                  gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """BERT4Rec's inputs from a feed batch, on the batch's device (glue).
    ``gen`` (on that device) draws the cloze positions, ``MASK_RATE`` of the
    valid ones, and ``N_NEGATIVES`` shared negatives: the loss always takes
    its sampled-softmax branch."""
    mask = batch["uih_mask"]
    dev = mask.device
    mask_pos = (torch.rand(mask.shape, generator=gen, device=dev)
                < MASK_RATE) & mask
    return {
        "uih_item_id": (batch["uih_item_id"] % cfg.item_vocab).to(
            torch.int32),
        "uih_mask": mask,
        "mask_pos": mask_pos,
        "neg_ids": torch.randint(0, cfg.item_vocab, (N_NEGATIVES,),
                                 generator=gen, device=dev,
                                 dtype=torch.int32),
        "cand_item_id": (batch["cand_item_id"] % cfg.item_vocab).to(
            torch.int32),
    }
