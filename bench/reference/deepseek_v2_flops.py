"""Model FLOPs of a DeepSeek-V2-Lite training example, counted by hand.

Every product is counted as the plain reference (``deepseek_v2``) computes
it, forward and backward (each product's two operand gradients: three
times the forward): the attention scores and the value product of every
query against all ``seq_len`` positions, as ``torch.utils.flop_counter``
counts the reference (``reference.flops``); the router, the shared
experts, the dense layers and the unembedding at every token. The routed
experts count ``pairs`` (token, expert) pairs a token: the card's share
``top_k * held / router_experts`` for the step's FLOPs (0.75 for 6 of 64
with 8 held), the held experts' number where the reference runs them
densely.
"""
from __future__ import annotations


def share_pairs(cfg: dict) -> float:
    """Pairs a token the card's held experts compute on average."""
    return (cfg["num_experts_per_tok"] * cfg["n_routed_experts"]
            / cfg["deployment"]["router_experts"])


def per_example(cfg: dict, seq_len: int, pairs: float) -> float:
    """FLOPs of one sequence's forward and backward pass."""
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["kv_lora_rank"]
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    f, fs = cfg["moe_intermediate_size"], (cfg["n_shared_experts"]
                                           * cfg["moe_intermediate_size"])
    dense = cfg["first_k_dense_replace"]
    moe = cfg["num_hidden_layers"] - dense
    attn = 2 * (d * h * (nope + rope) + d * r + d * rope + r * h * nope
                + r * h * v + h * v * d) + 2 * seq_len * h * (nope + rope + v)
    dense_ffn = 6 * d * cfg["intermediate_size"]
    moe_ffn = (2 * d * cfg["deployment"]["router_experts"] + 6 * d * fs
               + pairs * 6 * d * f)
    token = ((dense + moe) * attn + dense * dense_ffn + moe * moe_ffn
             + 2 * d * cfg["vocab_size"])
    return 3.0 * token * seq_len
