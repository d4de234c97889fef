"""MeshGraphNet [arXiv:2010.03409]: 15 MP layers, d_hidden 128, sum
aggregator, 2-layer MLPs. d_node_in is overridden per graph shape.

Port of ``repro.configs.meshgraphnet``: the same ``FULL`` and ``SMOKE``
fields, with ``compute_dtype`` as a torch dtype."""
import torch

from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import MeshGraphNetConfig

FULL = MeshGraphNetConfig(
    name="meshgraphnet", n_layers=15, d_hidden=128, mlp_layers=2,
    d_node_in=16, d_edge_in=8, d_out=3, aggregator="sum",
)

SMOKE = MeshGraphNetConfig(
    name="meshgraphnet-smoke", n_layers=3, d_hidden=16, mlp_layers=2,
    d_node_in=8, d_edge_in=4, d_out=3, aggregator="sum",
    compute_dtype=torch.float32,
)


def spec() -> ArchSpec:
    return ArchSpec(
        "meshgraphnet", "gnn", FULL, SMOKE, GNN_SHAPES,
        notes="VLM technique not applicable (graphs are not append-only "
              "per-user sequences); uses generic DPP prefetch only.",
    )
