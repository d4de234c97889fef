"""Two-tower retrieval [Yi et al., RecSys'19]: embed 256, towers
1024-512-256, dot interaction, in-batch sampled softmax w/ logQ.

Port of ``repro.configs.two_tower_retrieval``: the same ``FULL`` and
``SMOKE`` widths, with ``compute_dtype`` as a torch dtype."""
import torch

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import TwoTowerConfig

FULL = TwoTowerConfig(
    name="two-tower-retrieval", embed_dim=256, tower_mlp=(1024, 512, 256),
    item_vocab=10_000_384, user_vocab=20_000_768, uih_len=100,
)

SMOKE = TwoTowerConfig(
    name="two-tower-smoke", embed_dim=16, tower_mlp=(32, 16),
    item_vocab=1_000, user_vocab=500, uih_len=12,
    compute_dtype=torch.float32,
)


def spec() -> ArchSpec:
    return ArchSpec("two-tower-retrieval", "recsys", FULL, SMOKE,
                    RECSYS_SHAPES)
