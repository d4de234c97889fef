"""DLRM-UIH — the paper's own flagship tenant: DLRM interaction + causal
transformer encoder over an ultra-long UIH sequence (the Fig.4 scaling knob).

Port of ``repro.configs.dlrm_uih``: the same ``FULL`` and ``SMOKE`` widths,
with ``compute_dtype`` as a torch dtype."""
import torch

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import DLRMUIHConfig

FULL = DLRMUIHConfig(
    name="dlrm-uih", seq_len=2048, d_seq=128, n_seq_layers=2, n_heads=4,
    n_dense=13, n_sparse=4, embed_dim=64, item_vocab=10_000_384,
    field_vocab=1_000_448,
)

SMOKE = DLRMUIHConfig(
    name="dlrm-uih-smoke", seq_len=32, d_seq=16, n_seq_layers=2, n_heads=2,
    n_dense=4, n_sparse=2, embed_dim=8, item_vocab=1_000, field_vocab=100,
    compute_dtype=torch.float32,
)


def spec() -> ArchSpec:
    return ArchSpec(
        "dlrm-uih", "recsys", FULL, SMOKE, RECSYS_SHAPES,
        notes="paper's own architecture (not from the assigned pool)",
    )
