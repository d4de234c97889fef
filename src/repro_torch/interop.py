"""Carry reference weights into the port.

torch and jax draw different numbers from one seed, so a parity test builds
parameters once with the JAX package and hands them over as numpy arrays
(``jax.tree.map(np.asarray, params)``, done by the caller). The port keeps
the JAX tree's layout: a nested ``nn.ParameterDict`` with the same keys and
``seq_blocks`` stacked on axis 0, as ``jax.vmap(block_init)`` makes it.
Split per layer, the stacked ``ln1``/``ln2`` would turn 1-D and lose the
weight decay AdamW gives every ``ndim >= 2`` leaf; the same layout also keeps
the checkpoint's leaf order identical.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.models.recsys import DLRMUIHConfig, TwoTowerConfig
from repro_torch.tree import to_parameter_dict, tree_leaves, tree_map

_TWO_TOWER_KEYS = ("item_mlp", "item_table", "user_mlp", "user_table")
_DLRM_UIH_KEYS = ("action_table", "dense_proj", "item_table", "seq_blocks",
                  "seq_ln", "seq_proj", "sparse_tables", "target_proj",
                  "top_mlp")


def dlrm_uih_params_from_numpy(tree: Mapping[str, Any], cfg: DLRMUIHConfig,
                               device: Any = "cuda") -> nn.ParameterDict:
    """The JAX ``init_dlrm_uih`` tree (numpy leaves) as the port's float32
    parameters on ``device``. Raises if the tree does not fit ``cfg``."""
    if tuple(sorted(tree)) != _DLRM_UIH_KEYS:
        raise ValueError(f"not a DLRM-UIH parameter tree: keys {sorted(tree)}")
    want = {
        "item_table": (cfg.item_vocab, cfg.d_seq),
        "sparse_tables": (cfg.n_sparse * cfg.field_vocab, cfg.embed_dim),
        "seq_ln": (cfg.d_seq,),
    }
    for key, shape in want.items():
        if tuple(np.shape(tree[key])) != shape:
            raise ValueError(f"{key}: shape {np.shape(tree[key])} does not "
                             f"match the config's {shape}")
    if any(np.shape(x)[0] != cfg.n_seq_layers
           for x in tree_leaves(tree["seq_blocks"])):
        raise ValueError("seq_blocks must be stacked on axis 0 over "
                         f"{cfg.n_seq_layers} layers")
    return to_parameter_dict(tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), device=device),
        tree))


def two_tower_params_from_numpy(tree: Mapping[str, Any], cfg: TwoTowerConfig,
                                device: Any = "cuda") -> nn.ParameterDict:
    """The JAX ``init_two_tower`` tree (numpy leaves) as the port's float32
    parameters on ``device``. Raises if the tree does not fit ``cfg``."""
    if tuple(sorted(tree)) != _TWO_TOWER_KEYS:
        raise ValueError(f"not a two-tower parameter tree: keys "
                         f"{sorted(tree)}")
    d = cfg.embed_dim
    want = {
        ("item_table",): (cfg.item_vocab, d),
        ("user_table",): (cfg.user_vocab, d),
        ("user_mlp", "w0"): (2 * d, cfg.tower_mlp[0]),
        ("item_mlp", "w0"): (d, cfg.tower_mlp[0]),
    }
    for path, shape in want.items():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if tuple(np.shape(leaf)) != shape:
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(leaf)} does "
                             f"not match the config's {shape}")
    n_layers = 2 * len(cfg.tower_mlp)   # a weight and a bias per layer
    for key in ("user_mlp", "item_mlp"):
        if len(tree[key]) != n_layers:
            raise ValueError(f"{key}: {len(tree[key])} leaves, the config's "
                             f"towers {cfg.tower_mlp} need {n_layers}")
    return to_parameter_dict(tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), device=device),
        tree))
