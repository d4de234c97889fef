"""Architecture registry plumbing: ``ArchSpec`` and the per-family shape
tables.

Port of ``repro.configs.base``: the same ``ArchSpec`` fields and the same
``LM_SHAPES``, ``GNN_SHAPES`` and ``RECSYS_SHAPES`` values, as plain dicts.
Every (arch x shape) cell is defined here; ``repro_torch.launch.steps`` turns
a (family, config, shape) triple into a step function and its input specs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                     # "lm" | "gnn" | "recsys"
    full: Any                       # full-size config (dry run, the card)
    smoke: Any                      # reduced config (CPU tests)
    shapes: Mapping[str, Mapping[str, Any]]
    notes: str = ""


# -- LM family: seq_len x global_batch; decode_*/long_* lower serve_step -----
LM_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    {"kind": "train",   "seq_len": 4_096,   "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32_768,  "batch": 32},
    "decode_32k":  {"kind": "decode",  "seq_len": 32_768,  "batch": 128},
    "long_500k":   {"kind": "decode",  "seq_len": 524_288, "batch": 1},
}

# -- GNN (meshgraphnet) -------------------------------------------------------
GNN_SHAPES: Dict[str, Dict[str, Any]] = {
    "full_graph_sm": {
        "kind": "train", "n_nodes": 2_708, "n_edges": 10_556, "d_feat": 1_433,
    },
    "minibatch_lg": {
        # reddit-scale parent graph; the *lowered* shapes are the padded
        # fanout-(15,10) sampled subgraph for 1024 seed nodes
        "kind": "train_sampled", "parent_nodes": 232_965,
        "parent_edges": 114_615_892, "batch_nodes": 1_024,
        "fanouts": (15, 10), "d_feat": 602,
        "n_nodes": 1_024 + 1_024 * 15 + 1_024 * 15 * 10,   # padded: 180,224
        "n_edges": 1_024 * 15 + 1_024 * 15 * 10,           # padded: 168,960
    },
    "ogb_products": {
        "kind": "train", "n_nodes": 2_449_029, "n_edges": 61_859_140,
        "d_feat": 100,
    },
    "molecule": {
        # 128 disjoint 30-node molecules flattened into one block-diagonal graph
        "kind": "train", "n_nodes": 30 * 128, "n_edges": 64 * 128, "d_feat": 16,
        "graphs": 128,
    },
}

# -- RecSys -------------------------------------------------------------------
RECSYS_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_batch":    {"kind": "train", "batch": 65_536},
    "serve_p99":      {"kind": "serve", "batch": 512},
    "serve_bulk":     {"kind": "serve", "batch": 262_144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1, "n_candidates": 1_000_000},
}
