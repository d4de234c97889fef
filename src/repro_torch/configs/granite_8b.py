"""Granite-8B-Code [arXiv:2405.04324]: llama-arch, 36L d4096 32H GQA(kv=8)
d_ff 14336 v49152.

Port of ``repro.configs.granite_8b``: the same ``FULL`` and ``SMOKE``
fields, with ``compute_dtype`` as a torch dtype."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="granite-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49_152, head_dim=128, qk_norm=False, rope_theta=1e4,
)

SMOKE = TransformerConfig(
    name="granite-8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=191, head_dim=16, qk_norm=False, rope_theta=1e4,
    compute_dtype=torch.float32, q_chunk=16, loss_chunk=16,
)


def spec() -> ArchSpec:
    return ArchSpec("granite-8b", "lm", FULL, SMOKE, LM_SHAPES)
