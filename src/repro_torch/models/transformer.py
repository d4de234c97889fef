"""Decoder-only transformer LM (GQA / MLA attention, dense / MoE FFN).

Port of ``repro.models.transformer``. Layer parameters are stacked along a
leading layer axis, as the reference's ``jax.vmap`` lays them out (and as
``repro_torch.interop`` hands them over); the blocks run in a Python loop
over per-layer views (``layers.unstack``), each under
``torch.utils.checkpoint`` when ``cfg.remat`` is set and gradients are on.
``scan_layers`` and ``unroll_scans`` are the reference's fields, kept so
the configs are equal field for field; an eager loop has no scan to
unroll. Cross-entropy is computed in sequence chunks so (B, S, vocab)
logits are never fully materialized.

Serving. ``prefill`` returns the last position's logits and a cache of the
prompt's length; ``decode_step`` writes each new token's entry into the
cache IN PLACE (the returned cache is the caller's, updated: equal to the
reference's functional result) and attends against the whole cache.

On a mesh of more than one rank every function is the rank-local program
of the reference's placements (``launch.shardings.lm_param_specs``,
``launch.steps``): the batch is blocked over ``data_axes`` (none where
the batch does not split over them), the layers are Megatron
tensor-parallel over ``model`` (``models.layers``), and the embedding and
unembedding hold this rank's block of vocabulary rows. The embedding
looks up the ids in its own rows and sums over ``model``; the loss is a
vocabulary-parallel cross-entropy (the row max, the sum of exponentials
and the target's logit each reduced over ``model``) and returns this
rank's SHARE of the global mean loss (``models.parallel``'s convention).
``prefill`` and ``decode_step`` return logits blocked over the vocabulary;
their caches are this rank's block of positions over ``model`` (every
axis where the batch does not split): prefill re-blocks each layer's k/v
columns by position with an all-to-all over ``model``.

Leading dense layers (``first_k_dense``, FFN width ``dense_d_ff``) are
stacked apart from the rest (``dense_blocks``). A dropless MoE
(``moe.capacity_factor=None``) adds its balance loss into ``loss_fn``.
Given a ``mask`` of the positions that count (left-padded histories),
``loss_fn`` masks the other positions as keys, leaves them out of the
cross-entropy and of the balance statistics, and averages over the valid
positions; ``history_lm_inputs`` makes tokens, targets and that mask of a
feed batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import parallel as PL
from repro_torch.models.embedding import row_partial
from repro_torch.models.moe import MoEConfig, init_moe, moe_dropless, moe_ffn
from repro_torch.tree import tree_leaves, to_parameter_dict

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    attention: str = "gqa"           # "gqa" | "mla"
    qk_norm: bool = False
    rope_theta: float = 1e6
    moe: Optional[MoEConfig] = None  # None = dense FFN
    # MLA geometry (attention == "mla")
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_scaling: Optional[L.YaRN] = None
    # leading dense layers, stacked apart (FFN width dense_d_ff, else d_ff)
    first_k_dense: int = 0
    dense_d_ff: Optional[int] = None
    # execution
    compute_dtype: torch.dtype = torch.bfloat16
    q_chunk: int = 512
    loss_chunk: int = 512
    remat: bool = True
    scan_layers: bool = True
    unroll_scans: bool = False

    @property
    def attn_cfg(self) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            qk_norm=self.qk_norm, rope_theta=self.rope_theta,
            q_chunk=self.q_chunk,
        )

    @property
    def mla_cfg(self) -> L.MLAConfig:
        return L.MLAConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            kv_lora_rank=self.kv_lora_rank, qk_nope_dim=self.qk_nope_dim,
            qk_rope_dim=self.qk_rope_dim, v_head_dim=self.v_head_dim,
            rope_theta=self.rope_theta, q_chunk=self.q_chunk,
            yarn=self.rope_scaling,
        )

    def param_count(self) -> int:
        """Parameters, counted from shapes on the ``meta`` device (nothing
        is allocated)."""
        return sum(t.numel() for t in tree_leaves(init(self, device="meta")))

    def active_param_count(self) -> int:
        """Active params per token (MoE: only the routed experts' expected
        pairs a token and the shared experts count). With an expert share
        the parameters hold the held experts, of which a token reaches
        ``top_k * held / n_experts`` on average."""
        total = self.param_count()
        if self.moe is None:
            return total
        e, k, held = self.moe.n_experts, self.moe.top_k, self.moe.held
        expert_p = (self.n_layers - self.first_k_dense) * (
            held * (3 * self.d_model * self.moe.d_ff)
        )
        active_expert_p = expert_p * k // e
        return total - expert_p + active_expert_p


def _init_block(gen: torch.Generator, cfg: TransformerConfig, device,
                dtype: torch.dtype, dense: bool = False) -> Params:
    if cfg.attention == "mla":
        attn = L.init_mla(gen, cfg.mla_cfg, device, dtype)
    else:
        attn = L.init_gqa(gen, cfg.attn_cfg, device, dtype)
    if cfg.moe is not None and not dense:
        ffn = init_moe(gen, cfg.d_model, cfg.moe, device, dtype)
    else:
        ffn = L.init_swiglu(gen, cfg.d_model,
                            (cfg.dense_d_ff or cfg.d_ff) if dense else
                            cfg.d_ff, device, dtype)
    return {
        "attn": attn,
        "ffn": ffn,
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }


def init(cfg: TransformerConfig, seed: int = 0, device="cuda",
         dtype: torch.dtype = torch.float32):
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``) in the reference's tree layout, blocks stacked on axis 0.
    float32 for training; serving passes ``dtype=torch.bfloat16``, and each
    leaf is then drawn in float32 a block of rows at a time and cast
    (``layers._init``), so no float32 copy of the model ever exists."""
    gen = L.generator(device, seed)
    tree = {"embed": L._init(gen, (cfg.vocab, cfg.d_model), 0.02, device,
                             dtype)}
    if cfg.first_k_dense:
        tree["dense_blocks"] = L.stack_blocks(
            cfg.first_k_dense,
            lambda: _init_block(gen, cfg, device, dtype, dense=True))
    tree["blocks"] = L.stack_blocks(
        cfg.n_layers - cfg.first_k_dense,
        lambda: _init_block(gen, cfg, device, dtype))
    tree["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device)
    tree["unembed"] = L._init(gen, (cfg.vocab, cfg.d_model), 0.02, device,
                              dtype)
    return to_parameter_dict(tree)


def layer_blocks(params: Params, cfg: TransformerConfig):
    """Every layer's (block, dense) in order: the leading dense blocks,
    then the stacked ones (dense too where ``cfg.moe`` is None)."""
    out = []
    if cfg.first_k_dense:
        out += [(blk, True) for blk in L.unstack(params["dense_blocks"],
                                                 cfg.first_k_dense)]
    rest = L.unstack(params["blocks"], cfg.n_layers - cfg.first_k_dense)
    return out + [(blk, cfg.moe is None) for blk in rest]


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _ffn(cfg: TransformerConfig, block: Params, hn: torch.Tensor, mesh,
         data_axes, dense: bool = False,
         mask: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the FFN's output, a dropless MoE's balance loss or None)."""
    if dense:
        return L.swiglu(block["ffn"], hn, mesh), None
    if cfg.moe.capacity_factor is None:
        if PL.tp(mesh):
            raise ValueError("the dropless layer runs on one card")
        return moe_dropless(block["ffn"], hn, cfg.moe, mask)
    return moe_ffn(block["ffn"], hn, cfg.moe, mesh=mesh,
                   data_axes=data_axes), None


def _block_fwd(cfg: TransformerConfig, mesh, data_axes, dense: bool,
               h: torch.Tensor, block: Params, positions: torch.Tensor,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the block's output, its MoE balance loss or None)."""
    hn = L.rms_norm(h, block["ln1"])
    if cfg.attention == "mla":
        attn_out = L.mla_attention_train(block["attn"], hn, positions,
                                         cfg.mla_cfg, mesh, kv_mask=mask)
    else:
        attn_out = L.gqa_attention(block["attn"], hn, positions,
                                   cfg.attn_cfg, kv_mask=mask, mesh=mesh)
    h = h + attn_out
    out, aux = _ffn(cfg, block, L.rms_norm(h, block["ln2"]), mesh, data_axes,
                    dense, mask)
    return h + out, aux


def _vocab_start(table: torch.Tensor, mesh) -> int:
    """The first vocabulary row of this rank's block of ``table``."""
    return PL.rank_of(mesh, ("model",)) * table.shape[0]


def _embed(params: Params, tokens: torch.Tensor, dt: torch.dtype,
           mesh=None) -> torch.Tensor:
    """The tokens' rows in ``dt``; on a mesh the ids in this rank's rows
    (the rest zero), summed over ``model``."""
    table = params["embed"]
    if not PL.tp(mesh):
        return table[tokens.long()].to(dt)
    rows = row_partial(table, tokens.long(), None,
                       PL.rank_of(mesh, ("model",)), dt)
    return PL.sum_over(rows, mesh, ("model",))


def cache_seq_axes(mesh, data_axes) -> tuple:
    """The axes a cache's positions are blocked over on ``mesh``
    (``launch.steps._kv_cache_spec``): ``model`` where the batch is split
    over the data axes, every axis where it is not."""
    return ("model",) if data_axes else tuple(mesh.mesh_dim_names)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def hidden_states(params: Params, tokens: torch.Tensor,
                  cfg: TransformerConfig, mesh=None, data_axes=("data",),
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(final-normed hidden states, the summed MoE balance loss or
    None)."""
    b, s = tokens.shape
    h = _embed(params, tokens, cfg.compute_dtype, mesh)
    positions = _positions(b, s, h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = None
    for block, dense in layer_blocks(params, cfg):
        args = (cfg, mesh, data_axes, dense, h, block, positions, mask)
        h, a = (checkpoint(_block_fwd, *args, use_reentrant=False) if remat
                else _block_fwd(*args))
        if a is not None:
            aux = a if aux is None else aux + a
    return L.rms_norm(h, params["final_norm"]), aux


def _xent_sum(logits: torch.Tensor, targets: torch.Tensor, mesh=None,
              v_start: int = 0, weight: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Summed cross-entropy (each position's times ``weight``, one card
    only); on a mesh ``logits`` are this rank's vocabulary columns from
    ``v_start``, and the row max, the sum of exponentials and the target's
    logit are reduced over ``model``."""
    logits = logits.float()
    if not PL.tp(mesh):
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        per = logz - gold
        return torch.sum(per if weight is None else per * weight)
    m_ax = ("model",)
    v_loc = logits.shape[-1]
    big = PL.max_over(logits.amax(dim=-1, keepdim=True), mesh, m_ax)
    sumexp = PL.sum_over(torch.exp(logits - big).sum(dim=-1), mesh, m_ax)
    local = targets.long() - v_start
    hit = (local >= 0) & (local < v_loc)
    gold = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])
    gold = PL.sum_over(gold[..., 0] * hit.to(logits.dtype), mesh, m_ax)
    return torch.sum(torch.log(sumexp) + big[..., 0] - gold)


def _chunk_loss(h: torch.Tensor, unemb: torch.Tensor, targets: torch.Tensor,
                mesh=None, v_start: int = 0,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _xent_sum(h @ unemb.T, targets, mesh, v_start, weight)


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: TransformerConfig, mesh=None, data_axes=("data",),
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy, plus the MoE balance loss of a
    dropless layer; the vocab projection in sequence chunks of
    ``loss_chunk`` (each recomputed in the backward under ``remat``, so
    one chunk's logits live at a time). With ``mask`` (B, S, one card
    only) the mean is over the valid positions (module docstring). On a
    mesh: this rank's share of the global mean (module docstring)."""
    h, aux = hidden_states(params, tokens, cfg, mesh, data_axes,
                           mask)                               # (B, S, D)
    b, s, _ = h.shape
    unemb = params["unembed"].to(cfg.compute_dtype)
    n = b * s
    v_start = 0
    weight = None
    if mask is not None:
        if PL.tp(mesh):
            raise ValueError("a masked loss runs on one card")
        weight = mask.to(torch.float32)
        n = weight.sum().clamp(min=1.0)
    if PL.tp(mesh):
        # the global token count (b * s on each batch block) times the
        # ranks that compute each block's loss: this rank's share
        n *= mesh.size()
        v_start = _vocab_start(params["unembed"], mesh)
    lc = min(cfg.loss_chunk, s)
    if s % lc:                                            # ragged: no chunking
        loss = _xent_sum(h @ unemb.T, targets, mesh, v_start, weight) / n
    else:
        remat = cfg.remat and torch.is_grad_enabled()
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for lo in range(0, s, lc):
            args = (h[:, lo:lo + lc], unemb, targets[:, lo:lo + lc], mesh,
                    v_start, None if weight is None else weight[:, lo:lo + lc])
            total = total + (checkpoint(_chunk_loss, *args,
                                        use_reentrant=False)
                             if remat else _chunk_loss(*args))
        loss = total / n
    return loss if aux is None else loss + aux


def history_lm_inputs(batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tokens, targets, mask) of a dense feed batch read as next-item
    prediction: the history's item ids are the tokens, each position's
    target is the next event's item and the last position's the
    candidate's, and the mask is the history's (left-padded rows)."""
    tokens = batch["uih_item_id"]
    targets = torch.cat([tokens[:, 1:], batch["cand_item_id"][:, None].to(
        tokens.dtype)], dim=1)
    return tokens, targets, batch["uih_mask"]


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype=None, device="cuda") -> Dict[str, torch.Tensor]:
    dt = dtype or cfg.compute_dtype
    nl = cfg.n_layers

    def zeros(*shape):
        return torch.zeros((nl, batch, max_len, *shape), dtype=dt,
                           device=device)

    if cfg.attention == "mla":
        return {"c_kv": zeros(cfg.kv_lora_rank), "k_pe": zeros(cfg.qk_rope_dim)}
    return {"k": zeros(cfg.n_kv_heads, cfg.head_dim),
            "v": zeros(cfg.n_kv_heads, cfg.head_dim)}


def _logits(params: Params, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    h = L.rms_norm(h, params["final_norm"])
    return h @ params["unembed"].to(dt).T


def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None, data_axes=("data",)
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process a full prompt; return last-position logits (B, vocab) and a
    populated cache of the prompt's length, stacked (L, B, S, ...), each
    layer's entries written into it as the layer runs."""
    if PL.tp(mesh):
        return _prefill_local(params, tokens, cfg, mesh, data_axes)
    b, s = tokens.shape
    dt = cfg.compute_dtype
    h = _embed(params, tokens, dt)
    positions = _positions(b, s, h.device)
    cache = init_kv_cache(cfg, b, s, device=h.device)
    for i, (block, dense) in enumerate(layer_blocks(params, cfg)):
        hn = L.rms_norm(h, block["ln1"])
        if cfg.attention == "mla":
            c_kv, k_pe = L.mla_new_cache_entries(block["attn"], hn,
                                                 positions, cfg.mla_cfg)
            attn_out = L.mla_attention_train(block["attn"], hn, positions,
                                             cfg.mla_cfg)
            cache["c_kv"][i], cache["k_pe"][i] = c_kv, k_pe
        else:
            q, k, v = L._qkv(block["attn"], hn, positions, cfg.attn_cfg)
            out = L._attend_chunked(q, k, v, positions, positions, None,
                                    True, cfg.q_chunk)
            attn_out = out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ \
                block["attn"]["wo"].to(dt)
            cache["k"][i], cache["v"][i] = k, v
        h = h + attn_out
        h = h + _ffn(cfg, block, L.rms_norm(h, block["ln2"]), mesh,
                     data_axes, dense)[0]
    return _logits(params, h[:, -1, :], dt), cache


def _prefill_local(params: Params, tokens: torch.Tensor,
                   cfg: TransformerConfig, mesh, data_axes
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``prefill``'s rank-local program: logits of this rank's vocabulary
    rows, and this rank's block of the cache's positions."""
    b, s = tokens.shape
    dt = cfg.compute_dtype
    m_ax = ("model",)
    seq_axes = cache_seq_axes(mesh, data_axes)
    h = _embed(params, tokens, dt, mesh)
    positions = _positions(b, s, h.device)
    cache = init_kv_cache(cfg, b, s // PL.size_of(mesh, seq_axes),
                          device=h.device)
    for i, (block, dense) in enumerate(layer_blocks(params, cfg)):
        hn = L.rms_norm(h, block["ln1"])
        if cfg.attention == "mla":
            c_kv, k_pe = L.mla_new_cache_entries(block["attn"], hn,
                                                 positions, cfg.mla_cfg)
            attn_out = L.mla_attention_train(block["attn"], hn, positions,
                                             cfg.mla_cfg, mesh)
            cache["c_kv"][i] = PL.block(c_kv, 1, mesh, seq_axes)
            cache["k_pe"][i] = PL.block(k_pe, 1, mesh, seq_axes)
        else:
            part, k, v = L.gqa_local(block["attn"], hn, positions,
                                     cfg.attn_cfg, mesh)
            attn_out = PL.sum_over(part, mesh, m_ax)
            for name, cols in (("k", k), ("v", v)):
                pos = PL.columns_to_positions(cols, mesh, "model", seq_axes)
                cache[name][i] = pos.reshape(cache[name][i].shape)
        h = h + attn_out
        h = h + _ffn(cfg, block, L.rms_norm(h, block["ln2"]), mesh,
                     data_axes, dense)[0]
    return _logits(params, h[:, -1, :], dt), cache


def decode_step(params: Params, cache: Dict[str, torch.Tensor],
                next_token: torch.Tensor,   # (B,) int
                position: torch.Tensor,     # (B,) current position to write
                cfg: TransformerConfig,
                mesh=None, data_axes=("data",)
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token of autoregressive decode against a (large) KV cache: each
    layer writes the token's entry at ``position`` (in place, the start
    clamped into the cache) and attends to every entry at or before it.
    Returns (logits (B, vocab), ``cache``). On a mesh the cache is this
    rank's block of positions (``cache_seq_axes``) and the logits its
    block of the vocabulary."""
    dt = cfg.compute_dtype
    tp = PL.tp(mesh)
    seq_axes = cache_seq_axes(mesh, data_axes) if tp else ()
    h = _embed(params, next_token, dt, mesh)[:, None, :]     # (B, 1, D)
    pos = position[:, None]
    for i, (block, dense) in enumerate(layer_blocks(params, cfg)):
        hn = L.rms_norm(h, block["ln1"])
        if cfg.attention == "mla":
            c_new, pe_new = L.mla_new_cache_entries(block["attn"], hn, pos,
                                                    cfg.mla_cfg)
            c_kv, k_pe = cache["c_kv"][i], cache["k_pe"][i]
            if tp:
                L.write_owned(c_kv, c_new, position, mesh, seq_axes)
                L.write_owned(k_pe, pe_new, position, mesh, seq_axes)
                kv_mask = L.local_decode_mask(position, c_kv.shape[1], mesh,
                                              seq_axes)
            else:
                L._write_at(c_kv, c_new, position)
                L._write_at(k_pe, pe_new, position)
                kv_mask = L._decode_mask(position, c_kv.shape[1])
            attn_out = L.mla_attention_decode(block["attn"], hn, pos, c_kv,
                                              k_pe, kv_mask, cfg.mla_cfg,
                                              mesh, seq_axes)
        else:
            attn_out, _, _ = L.gqa_decode(block["attn"], hn, pos,
                                          cache["k"][i], cache["v"][i],
                                          cfg.attn_cfg, mesh, seq_axes)
        h = h + attn_out
        h = h + _ffn(cfg, block, L.rms_norm(h, block["ln2"]), mesh,
                     data_axes, dense)[0]
    return _logits(params, h[:, 0, :], dt), cache

