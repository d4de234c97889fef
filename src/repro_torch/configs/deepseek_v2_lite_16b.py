"""DeepSeek-V2-Lite [arXiv:2405.04434]: 27L d2048 16H MLA (kv_lora 512,
nope 128 / rope 64 / v 128), MoE 64 routed top-6 + 2 shared, per-expert
d_ff 1408, v102400.

Port of ``repro.configs.deepseek_v2_lite_16b``: the same ``FULL`` and
``SMOKE`` fields, with ``compute_dtype`` as a torch dtype. As in the
reference, V2-Lite's first dense layer is folded into the homogeneous MoE
stack (DESIGN.md, Arch-applicability)."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=102_400, attention="mla",
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    rope_theta=1e4,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2),
)

SMOKE = TransformerConfig(
    name="deepseek-v2-lite-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=48, vocab=193, attention="mla", kv_lora_rank=32,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, rope_theta=1e4,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=48, n_shared=1),
    compute_dtype=torch.float32, q_chunk=16, loss_chunk=16,
)


def spec() -> ArchSpec:
    return ArchSpec("deepseek-v2-lite-16b", "lm", FULL, SMOKE, LM_SHAPES)
