"""BERT4Rec [arXiv:1904.06690]: embed 64, 2 blocks, 2 heads, seq 200,
bidirectional cloze objective.

Port of ``repro.configs.bert4rec``: the same ``FULL`` and ``SMOKE`` widths,
with ``compute_dtype`` as a torch dtype."""
import torch

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import BERT4RecConfig

FULL = BERT4RecConfig(
    name="bert4rec", embed_dim=64, n_blocks=2, n_heads=2, seq_len=200,
    item_vocab=1_000_448, loss_chunk=50,
)

SMOKE = BERT4RecConfig(
    name="bert4rec-smoke", embed_dim=16, n_blocks=2, n_heads=2, seq_len=16,
    item_vocab=300, compute_dtype=torch.float32,
)


def spec() -> ArchSpec:
    return ArchSpec("bert4rec", "recsys", FULL, SMOKE, RECSYS_SHAPES)
