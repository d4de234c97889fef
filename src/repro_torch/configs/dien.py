"""DIEN [arXiv:1809.03672]: embed 18, seq 100, GRU 108 + AUGRU interest
evolution, MLP 200-80.

Port of ``repro.configs.dien``: the same ``FULL`` and ``SMOKE`` widths, with
``compute_dtype`` as a torch dtype."""
import torch

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import DIENConfig

FULL = DIENConfig(
    name="dien", embed_dim=18, seq_len=100, gru_dim=108, mlp=(200, 80),
    item_vocab=1_000_448, cat_vocab=10_240,
)

SMOKE = DIENConfig(
    name="dien-smoke", embed_dim=8, seq_len=12, gru_dim=16, mlp=(16, 8),
    item_vocab=500, cat_vocab=50, compute_dtype=torch.float32,
)


def spec() -> ArchSpec:
    return ArchSpec("dien", "recsys", FULL, SMOKE, RECSYS_SHAPES)
