"""Qwen3-8B [hf:Qwen/Qwen3-8B]: 36L d4096 32H GQA(kv=8) d_ff 12288 v151936,
qk-norm.

Port of ``repro.configs.qwen3_8b``: the same ``FULL`` and ``SMOKE`` fields,
with ``compute_dtype`` as a torch dtype."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151_936, head_dim=128, qk_norm=True, rope_theta=1e6,
)

SMOKE = TransformerConfig(
    name="qwen3-8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=211, head_dim=16, qk_norm=True, rope_theta=1e6,
    compute_dtype=torch.float32, q_chunk=16, loss_chunk=16,
)


def spec() -> ArchSpec:
    return ArchSpec("qwen3-8b", "lm", FULL, SMOKE, LM_SHAPES)
