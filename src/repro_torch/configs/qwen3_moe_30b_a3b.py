"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L d2048 32H GQA(kv=4),
MoE 128 experts top-8, per-expert d_ff 768, v151936, qk-norm.

Port of ``repro.configs.qwen3_moe_30b_a3b``: the same ``FULL`` and
``SMOKE`` fields, with ``compute_dtype`` as a torch dtype."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=768, vocab=151_936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768, n_shared=0),
)

SMOKE = TransformerConfig(
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=211, head_dim=16, qk_norm=True, rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=0),
    compute_dtype=torch.float32, q_chunk=16, loss_chunk=16,
)


def spec() -> ArchSpec:
    return ArchSpec("qwen3-moe-30b-a3b", "lm", FULL, SMOKE, LM_SHAPES)
