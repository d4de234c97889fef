"""DeepSeek-V2-Lite as the port trains it on the feed: the port's
configuration object for one card's share of the experts and its loss over
a feed batch read as next-item prediction (``transformer.history_lm_inputs``:
the history's item ids are the tokens)."""
from __future__ import annotations

import torch

from bench.reference import deepseek_v2 as reference  # noqa: F401  (by name)
from repro_torch.models import transformer as T
# imported here, so that a port without it fails as the cell starts
from repro_torch.models.layers import YaRN
from repro_torch.models.moe import MoEConfig


def port_config(cfg: dict) -> T.TransformerConfig:
    """The port's ``TransformerConfig`` of a configuration file."""
    ys = cfg["rope_scaling"]
    dep = cfg["deployment"]
    kinds = (cfg["scoring_func"], cfg["topk_method"],
             cfg["routed_scaling_factor"], cfg["q_lora_rank"], ys["type"],
             cfg["moe_layer_freq"], cfg["tie_word_embeddings"])
    if kinds != ("softmax", "greedy", 1, None, "yarn", 1, False):
        raise ValueError(f"the port runs softmax scores, greedy top-k, scale "
                         f"1, no q LoRA, YaRN, MoE in every layer past the "
                         f"dense ones and an untied unembedding; got {kinds}")
    return T.TransformerConfig(
        name=cfg["name"], n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"], vocab=cfg["vocab_size"],
        attention="mla", kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_dim=cfg["qk_nope_head_dim"],
        qk_rope_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        rope_theta=float(cfg["rope_theta"]),
        rope_scaling=YaRN(
            factor=ys["factor"],
            original_max_position=ys["original_max_position_embeddings"],
            beta_fast=ys["beta_fast"], beta_slow=ys["beta_slow"],
            mscale=ys["mscale"], mscale_all_dim=ys["mscale_all_dim"]),
        first_k_dense=cfg["first_k_dense_replace"],
        dense_d_ff=cfg["intermediate_size"],
        moe=MoEConfig(n_experts=dep["router_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_ff=cfg["moe_intermediate_size"],
                      n_shared=cfg["n_shared_experts"], capacity_factor=None,
                      n_held=cfg["n_routed_experts"],
                      first_held=dep["first_held"],
                      norm_topk_prob=cfg["norm_topk_prob"],
                      aux_alpha=cfg["aux_loss_alpha"]),
        compute_dtype=getattr(torch, cfg["compute_dtype"]),
        q_chunk=cfg["q_chunk"], loss_chunk=cfg["loss_chunk"],
        remat=cfg["remat"])


def program_loss(cfg: dict):
    """The loss over a feed batch."""
    pc = port_config(cfg)

    def loss_fn(params, batch):
        tokens, targets, mask = T.history_lm_inputs(batch)
        return T.loss_fn(params, tokens, targets, pc, mask=mask)

    return loss_fn
