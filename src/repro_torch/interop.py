"""Carry reference weights into the port.

torch and jax draw different numbers from one seed, so a parity test builds
parameters once with the JAX package and hands them over as numpy arrays
(``jax.tree.map(np.asarray, params)``, done by the caller). The port keeps
the JAX tree's layout: a nested ``nn.ParameterDict`` with the same keys and
``seq_blocks``/``blocks`` stacked on axis 0, as ``jax.vmap(block_init)``
makes them. Split per layer, the stacked ``ln1``/``ln2`` would turn 1-D and
lose the weight decay AdamW gives every ``ndim >= 2`` leaf; the same layout
also keeps the checkpoint's leaf order identical.

Each function checks the tree's keys and the config's shapes, and raises
``ValueError`` on a tree that does not fit.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.gnn import MeshGraphNetConfig
from repro_torch.models.recsys import (
    BERT4RecConfig,
    DCNv2Config,
    DIENConfig,
    DLRMUIHConfig,
    TwoTowerConfig,
)
from repro_torch.models.transformer import TransformerConfig
from repro_torch.tree import to_parameter_dict, tree_leaves, tree_map

_TWO_TOWER_KEYS = ("item_mlp", "item_table", "user_mlp", "user_table")
_DLRM_UIH_KEYS = ("action_table", "dense_proj", "item_table", "seq_blocks",
                  "seq_ln", "seq_proj", "sparse_tables", "target_proj",
                  "top_mlp")
_DIEN_KEYS = ("att_w", "augru", "cat_table", "gru1", "item_table", "mlp")
_BERT4REC_KEYS = ("blocks", "final_ln", "item_table", "pos_table")


def _checked(tree: Mapping[str, Any], what: str, keys: Sequence[str],
             shapes: Mapping[Tuple[str, ...], Tuple[int, ...]],
             mlps: Optional[Mapping[str, int]] = None,
             stacked: Optional[Tuple[str, int]] = None) -> Mapping[str, Any]:
    """Raise unless ``tree`` has exactly ``keys``, each leaf path of
    ``shapes`` its shape, each MLP of ``mlps`` that many layers (a weight
    and a bias each), and every leaf under ``stacked[0]`` ``stacked[1]``
    rows on axis 0."""
    if tuple(sorted(tree)) != tuple(sorted(keys)):
        raise ValueError(f"not a {what} parameter tree: keys {sorted(tree)}")
    for path, shape in shapes.items():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if tuple(np.shape(leaf)) != shape:
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(leaf)} does "
                             f"not match the config's {shape}")
    for key, n_layers in (mlps or {}).items():
        if len(tree[key]) != 2 * n_layers:
            raise ValueError(f"{key}: {len(tree[key])} leaves, the config's "
                             f"{n_layers} layers need {2 * n_layers}")
    if stacked is not None:
        key, n = stacked
        if any(np.shape(x)[0] != n for x in tree_leaves(tree[key])):
            raise ValueError(f"{key} must be stacked on axis 0 over {n} "
                             f"layers")
    return tree


def _params(tree: Mapping[str, Any], device: Any) -> nn.ParameterDict:
    return to_parameter_dict(tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), device=device),
        tree))


def dlrm_uih_params_from_numpy(tree: Mapping[str, Any], cfg: DLRMUIHConfig,
                               device: Any = "cuda") -> nn.ParameterDict:
    """The JAX ``init_dlrm_uih`` tree (numpy leaves) as the port's float32
    parameters on ``device``. Raises if the tree does not fit ``cfg``."""
    return _params(_checked(tree, "DLRM-UIH", _DLRM_UIH_KEYS, {
        ("item_table",): (cfg.item_vocab, cfg.d_seq),
        ("sparse_tables",): (cfg.n_sparse * cfg.field_vocab, cfg.embed_dim),
        ("seq_ln",): (cfg.d_seq,),
    }, stacked=("seq_blocks", cfg.n_seq_layers)), device)


def two_tower_params_from_numpy(tree: Mapping[str, Any], cfg: TwoTowerConfig,
                                device: Any = "cuda") -> nn.ParameterDict:
    """The JAX ``init_two_tower`` tree (numpy leaves) as the port's float32
    parameters on ``device``. Raises if the tree does not fit ``cfg``."""
    d = cfg.embed_dim
    n = len(cfg.tower_mlp)
    return _params(_checked(tree, "two-tower", _TWO_TOWER_KEYS, {
        ("item_table",): (cfg.item_vocab, d),
        ("user_table",): (cfg.user_vocab, d),
        ("user_mlp", "w0"): (2 * d, cfg.tower_mlp[0]),
        ("item_mlp", "w0"): (d, cfg.tower_mlp[0]),
    }, mlps={"user_mlp": n, "item_mlp": n}), device)


def dcn_v2_params_from_numpy(tree: Mapping[str, Any], cfg: DCNv2Config,
                             device: Any = "cuda") -> nn.ParameterDict:
    """The JAX ``init_dcn_v2`` tree (numpy leaves) as the port's float32
    parameters on ``device``. Raises if the tree does not fit ``cfg``."""
    d = cfg.d_interact
    cross = [f"cross_{w}{i}" for i in range(cfg.n_cross_layers)
             for w in ("w", "b")]
    shapes = {("embed",): (cfg.n_sparse * cfg.field_vocab, cfg.embed_dim),
              ("mlp", "w0"): (d, cfg.mlp[0]),
              ("head", "w0"): (cfg.mlp[-1] + d, 1)}
    for i in range(cfg.n_cross_layers):
        shapes[(f"cross_w{i}",)] = (d, d)
        shapes[(f"cross_b{i}",)] = (d,)
    return _params(_checked(tree, "DCN-v2", ("embed", "head", "mlp", *cross),
                            shapes, mlps={"mlp": len(cfg.mlp), "head": 1}),
                   device)


def dien_params_from_numpy(tree: Mapping[str, Any], cfg: DIENConfig,
                           device: Any = "cuda") -> nn.ParameterDict:
    """The JAX ``init_dien`` tree (numpy leaves) as the port's float32
    parameters on ``device``. Raises if the tree does not fit ``cfg``."""
    h = cfg.gru_dim
    return _params(_checked(tree, "DIEN", _DIEN_KEYS, {
        ("item_table",): (cfg.item_vocab, cfg.embed_dim),
        ("cat_table",): (cfg.cat_vocab, cfg.embed_dim),
        ("gru1", "wx"): (cfg.d_in, 3 * h),
        ("gru1", "wh"): (h, 3 * h),
        ("augru", "wx"): (h, 3 * h),
        ("augru", "wh"): (h, 3 * h),
        ("att_w",): (h, cfg.d_in),
        ("mlp", "w0"): (h + 2 * cfg.d_in, cfg.mlp[0]),
    }, mlps={"mlp": len(cfg.mlp) + 1}), device)


def bert4rec_params_from_numpy(tree: Mapping[str, Any], cfg: BERT4RecConfig,
                               device: Any = "cuda") -> nn.ParameterDict:
    """The JAX ``init_bert4rec`` tree (numpy leaves) as the port's float32
    parameters on ``device``. Raises if the tree does not fit ``cfg``."""
    d = cfg.embed_dim
    return _params(_checked(tree, "BERT4Rec", _BERT4REC_KEYS, {
        ("item_table",): (cfg.item_vocab, d),
        ("pos_table",): (cfg.seq_len, d),
        ("final_ln",): (d,),
        ("blocks", "attn", "wq"): (cfg.n_blocks, d, d),
    }, stacked=("blocks", cfg.n_blocks)), device)


def transformer_params_from_numpy(tree: Mapping[str, Any],
                                  cfg: TransformerConfig,
                                  device: Any = "cuda") -> nn.ParameterDict:
    """The JAX ``transformer.init`` tree (numpy leaves) as the port's
    float32 parameters on ``device``, blocks stacked on axis 0. Raises if
    the tree does not fit ``cfg`` (its attention, FFN and shapes)."""
    d, n = cfg.d_model, cfg.n_layers
    if cfg.attention == "mla":
        h = cfg.n_heads
        attn = {"wq": (d, h * (cfg.qk_nope_dim + cfg.qk_rope_dim)),
                "w_dkv": (d, cfg.kv_lora_rank),
                "w_k_rope": (d, cfg.qk_rope_dim),
                "w_uk": (cfg.kv_lora_rank, h * cfg.qk_nope_dim),
                "w_uv": (cfg.kv_lora_rank, h * cfg.v_head_dim),
                "wo": (h * cfg.v_head_dim, d),
                "kv_norm": (cfg.kv_lora_rank,)}
    else:
        hq, hk = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        attn = {"wq": (d, hq), "wk": (d, hk), "wv": (d, hk), "wo": (hq, d)}
        if cfg.qk_norm:
            attn.update(q_norm=(cfg.head_dim,), k_norm=(cfg.head_dim,))
    if cfg.moe is None:
        ffn = {"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
               "w_down": (cfg.d_ff, d)}
    else:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff
        ffn = {"router": (d, e), "w_in": (e, d, 2 * f), "w_out": (e, f, d)}
        if cfg.moe.n_shared:
            fs = cfg.moe.n_shared * f
            ffn.update(shared_w_in=(d, 2 * fs), shared_w_out=(fs, d))
    shapes = {("embed",): (cfg.vocab, d), ("unembed",): (cfg.vocab, d),
              ("final_norm",): (d,)}
    _checked(tree, "transformer", ("blocks", "embed", "final_norm",
                                   "unembed"), shapes)
    blocks = tree["blocks"]
    _checked(blocks, "transformer block", ("attn", "ffn", "ln1", "ln2"),
             {("ln1",): (n, d), ("ln2",): (n, d)})
    for part, want in (("attn", attn), ("ffn", ffn)):
        _checked(blocks[part], f"transformer {part}", tuple(want),
                 {(k,): (n, *shape) for k, shape in want.items()})
    return _params(tree, device)


def meshgraphnet_params_from_numpy(tree: Mapping[str, Any],
                                   cfg: MeshGraphNetConfig,
                                   device: Any = "cuda") -> nn.ParameterDict:
    """The JAX ``gnn.init`` tree (numpy leaves) as the port's float32
    parameters on ``device``, blocks stacked on axis 0. Raises if the tree
    does not fit ``cfg``."""
    h, m = cfg.d_hidden, cfg.mlp_layers
    _checked(tree, "MeshGraphNet", ("blocks", "decoder", "edge_encoder",
                                    "node_encoder"), {
        ("node_encoder", "w0"): (cfg.d_node_in, h),
        ("edge_encoder", "w0"): (cfg.d_edge_in, h),
        ("decoder", f"w{m - 1}"): (h, cfg.d_out),
    }, mlps={"node_encoder": m, "edge_encoder": m, "decoder": m},
        stacked=("blocks", cfg.n_layers))
    blocks = tree["blocks"]
    _checked(blocks, "MeshGraphNet block", ("edge_ln", "edge_mlp", "node_ln",
                                            "node_mlp"), {
        ("edge_mlp", "w0"): (cfg.n_layers, 3 * h, h),
        ("node_mlp", "w0"): (cfg.n_layers, 2 * h, h),
        ("edge_ln",): (cfg.n_layers, h),
    }, mlps={"edge_mlp": m, "node_mlp": m})
    return _params(tree, device)
