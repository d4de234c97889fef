"""DCN-v2 [arXiv:2008.13535]: 13 dense + 26 sparse, embed 16, 3 full-rank
cross layers, deep MLP 1024-1024-512.

Port of ``repro.configs.dcn_v2``: the same ``FULL`` and ``SMOKE`` widths,
with ``compute_dtype`` as a torch dtype."""
import torch

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import DCNv2Config

FULL = DCNv2Config(
    name="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16, n_cross_layers=3,
    mlp=(1024, 1024, 512), field_vocab=1_000_448,
)

SMOKE = DCNv2Config(
    name="dcn-v2-smoke", n_dense=13, n_sparse=5, embed_dim=4,
    n_cross_layers=2, mlp=(32, 16), field_vocab=100,
    compute_dtype=torch.float32,
)


def spec() -> ArchSpec:
    return ArchSpec("dcn-v2", "recsys", FULL, SMOKE, RECSYS_SHAPES)
