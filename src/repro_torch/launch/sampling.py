"""Materialize runnable inputs for a Cell (tests, the card's cells).

Port of ``repro.launch.sampling``. The dry run never calls this: it traces
from ``S`` records. Batch leaves are drawn from ``np.random.default_rng(seed)``
exactly as the reference draws them: leaf by leaf in ``jax.tree_util``'s
flatten order, which takes a dict's keys SORTED (``repro_torch.tree`` walks
the same order), with the same bounds and distributions, so one seed gives
byte-equal batches in both packages (ids bounded by the config's
vocabularies, senders and receivers below the node count, decode
positions zero, masks non-degenerate, floats standard-normal; a GNN's
edges padded to a multiple of the mesh's ranks are drawn like the others,
their mask too); a KV cache is zeros. Parameters come from the port's ``init`` functions with a
``torch.Generator`` seeded by ``seed`` (torch and jax draw different
numbers; tests hand the reference's parameters over through
``repro_torch.interop`` instead). A serving LM's bf16 weights are drawn
leaf by leaf on ``device`` and cast a block of rows at a time
(``transformer.init(dtype=bfloat16)``), where the reference builds the
float32 tree and casts it: FULL Qwen3-MoE's float32 tree is 122 GB.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.launch import shardings as SH
from repro_torch.launch.steps import Cell, S
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWState, adamw_init
from repro_torch.tree import tree_map

_INIT_FNS = {
    "two-tower-retrieval": R.init_two_tower,
    "dcn-v2": R.init_dcn_v2,
    "dien": R.init_dien,
    "bert4rec": R.init_bert4rec,
    "dlrm-uih": R.init_dlrm_uih,
}

_NUMPY = {torch.int32: np.int32, torch.int64: np.int64,
          torch.float32: np.float32, torch.bool: np.bool_}


def _vocab_for(name: str, cfg, meta) -> int:
    c = cfg
    table = {
        "tokens": getattr(c, "vocab", 0),
        "targets": getattr(c, "vocab", 0),
        "token": getattr(c, "vocab", 0),
        "uih_item_id": getattr(c, "item_vocab", 0),
        "cand_item_id": getattr(c, "item_vocab", 0),
        "neg_ids": getattr(c, "item_vocab", 0),
        "user_id": getattr(c, "user_vocab", 0),
        "uih_category": getattr(c, "cat_vocab", 0),
        "cand_category": getattr(c, "cat_vocab", 0),
        "sparse_ids": getattr(c, "field_vocab", 0),
        "uih_action_type": 16,
        "senders": meta.get("n_nodes", 0),
        "receivers": meta.get("n_nodes", 0),
        "position": meta.get("kv_len", 1),
    }
    return table.get(name, 0)


def _sample_leaf(name: str, leaf: S, cfg, meta, rng: np.random.Generator
                 ) -> np.ndarray:
    shape, dtype = leaf.shape, leaf.dtype
    if name == "position":
        return np.zeros(shape, _NUMPY[dtype])
    if dtype == torch.bool:
        if "mask_pos" in name:
            return rng.random(shape) < 0.2
        return rng.random(shape) < 0.9
    if not dtype.is_floating_point:
        hi = max(_vocab_for(name, cfg, meta), 2)
        return rng.integers(0, hi, size=shape).astype(_NUMPY[dtype])
    if name == "label":
        return (rng.random(shape) < 0.3).astype(np.float32)
    if name == "log_q":
        return np.zeros(shape, np.float32)
    return rng.standard_normal(shape).astype(_NUMPY[dtype])


def _sample_tree(arg: Any, cfg, meta, rng, device) -> Any:
    """A batch dict (sampled in sorted key order) or one bare leaf (whose
    name is empty, as the reference's path-less leaf)."""
    def one(name, leaf):
        return torch.from_numpy(_sample_leaf(name, leaf, cfg, meta, rng)).to(
            device)

    if isinstance(arg, S):
        return one("", arg)
    return {k: one(k, arg[k]) for k in sorted(arg)}


def sample_args(cell: Cell, family: str, seed: int = 0,
                device: Any = "cuda"):
    """Positional args for ``cell.step_fn`` with real arrays on ``device``:
    float32 parameters for a train cell (and fresh AdamW moments), bf16
    ones for a serving cell (detached), a zero KV cache for a decode
    cell."""
    cfg = cell.meta["cfg"]
    rng = np.random.default_rng(seed)
    out = []
    for i, arg in enumerate(cell.args_spec):
        if i == 0:  # params
            out.append(_params(cell, family, cfg, arg, seed, device))
            continue
        if isinstance(arg, AdamWState):
            out.append(adamw_init(out[0]))
            continue
        if _is_kv_cache(arg):
            out.append({k: torch.zeros(l.shape, dtype=l.dtype, device=device)
                        for k, l in arg.items()})
            continue
        out.append(_sample_tree(arg, cfg, cell.meta, rng, device))
    return tuple(out)


def _params(cell: Cell, family: str, cfg, spec, seed: int, device):
    if family == "lm":
        if cell.kind == "train":
            return T.init(cfg, seed=seed, device=device)
        with torch.no_grad():
            return tree_map(lambda p: p.detach(),
                            T.init(cfg, seed=seed, device=device,
                                   dtype=torch.bfloat16))
    if family == "gnn":
        return G.init(cfg, seed=seed, device=device)
    params = _INIT_FNS[cell.arch_id](cfg, seed=seed, device=device)
    if cell.kind != "train":
        params = tree_map(lambda p, sp: p.detach().to(sp.dtype), params, spec)
    return params


def _is_kv_cache(arg) -> bool:
    return isinstance(arg, dict) and (set(arg) == {"k", "v"}
                                      or set(arg) == {"c_kv", "k_pe"})


def local_args(cell: Cell, args: tuple, mesh) -> tuple:
    """This rank's block of each of ``args`` (global tensors, as
    ``sample_args`` makes them) under the cell's input placements, each a
    tensor of its own: the form the rank-local ``cell.step_fn`` takes (its
    train step updates parameters and moments in place). The zoo's blocks
    are its rows of the vocabulary-parallel tables, its columns or rows of
    the tensor-parallel weights, its experts, its block of a cache's
    positions and its block of a graph's padded edges. On a mesh of one
    device every block is the whole tensor, and ``args`` come back as
    they are."""
    if mesh.size() == 1:
        return args
    return tuple(
        tree_map(lambda x, spec: SH.local_block(x, spec, mesh).clone(),
                 arg, sh)
        for arg, sh in zip(args, cell.in_shardings))
