"""Qwen3-4B [hf:Qwen/Qwen3-4B]: 36L d2560 32H GQA(kv=8) d_ff 9728 v151936,
qk-norm.

Port of ``repro.configs.qwen3_4b``: the same ``FULL`` and ``SMOKE`` fields,
with ``compute_dtype`` as a torch dtype."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151_936, head_dim=128, qk_norm=True, rope_theta=1e6,
)

SMOKE = TransformerConfig(
    name="qwen3-4b-smoke", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=173, head_dim=16, qk_norm=True, rope_theta=1e6,
    compute_dtype=torch.float32, q_chunk=16, loss_chunk=16,
)


def spec() -> ArchSpec:
    return ArchSpec("qwen3-4b", "lm", FULL, SMOKE, LM_SHAPES)
