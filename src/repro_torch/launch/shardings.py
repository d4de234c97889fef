"""Parameter / optimizer-state / input placement rules.

Port of ``repro.launch.shardings``, rule for rule. Conventions (DESIGN.md
§3):

  * LM dense weights: Megatron TP on the ``model`` axis (column-parallel
    q/k/v, gate/up and MLA's up-projections, row-parallel out and down),
    vocabulary-parallel embedding and unembedding.
  * MoE expert weights: the expert dim on ``model`` and the per-expert
    ``2f``/``f`` dim on ``data`` (FSDP, gathered per layer), or, in the
    ``2d`` decode layout, the contraction dims on ``data`` (resident).
  * GNN: parameters replicated, edges over every axis, nodes replicated.
  * Optimizer moments: parameter spec + ZeRO sharding of the first divisible
    unsharded dim over the data axes (ZeRO-2).
  * RecSys embedding tables: rows sharded over ``model``, replicated over
    the data axes (the row-sharded lookups of ``models/embedding.py``).

A leaf's spec is a ``P``: a tuple with one entry per tensor dim, each an
axis name, a tuple of axis names or ``None``, as ``jax.sharding.
PartitionSpec`` writes it (and equal to it). ``named`` turns a spec tree
into DTensor placements on a ``DeviceMesh``; ``local_shape`` and
``local_block`` give one rank's shape and block of a global tensor.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import (
    all_axes_of,
    axes_rank,
    axes_size,
    data_axes_of,
)
from repro_torch.tree import tree_map


class P(tuple):
    """A PartitionSpec: ``P("model", None)``; ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis this spec shards over."""
        return tuple(a for e in self if e is not None
                     for a in (e if isinstance(e, tuple) else (e,)))

    def dim_axes(self, dim: int) -> Tuple[str, ...]:
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e if isinstance(e, tuple) else (e,))


def is_spec(x: Any) -> bool:
    return isinstance(x, P)


def _map_with_path(fn, tree, path=()):
    """``fn("/".join(path), leaf)`` over a nested dict, keys sorted."""
    if isinstance(tree, dict) or hasattr(tree, "keys"):
        return {k: _map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree.keys())}
    return fn("/".join(path), tree)


# ---------------------------------------------------------------------------
# ZeRO sharding of optimizer moments
# ---------------------------------------------------------------------------

def zero_shard(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Add ``data`` sharding on the first unsharded dim whose size divides."""
    if "data" in spec.axes():
        return spec
    da = data_axes_of(mesh)
    data_size = axes_size(mesh, da)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, n) in enumerate(zip(dims, shape)):
        if e is None and n % data_size == 0 and n >= data_size:
            dims[i] = da if len(da) > 1 else da[0]
            return P(*dims)
    return spec


def opt_specs(param_specs, params_shape, mesh) -> Any:
    """AdamWState spec: step replicated; m/v ZeRO-sharded."""
    from repro_torch.train.optimizer import AdamWState

    mv = tree_map(lambda s, l: zero_shard(s, tuple(l.shape), mesh),
                  param_specs, params_shape, is_leaf=is_spec)
    return AdamWState(step=P(), m=mv, v=tree_map(lambda s: s, mv,
                                                 is_leaf=is_spec))


# ---------------------------------------------------------------------------
# LM params
# ---------------------------------------------------------------------------

def lm_param_specs(params_shape, mesh, moe_2d: bool = False) -> Any:
    """Spec tree of the transformer's parameters (blocks stacked on a
    leading layer dim). ``moe_2d``: the decode layout, expert weights fully
    sharded over (model x data), so no per-step all-gather."""
    def rule(name: str, leaf) -> P:
        nd = len(leaf.shape)
        if name in ("embed", "unembed"):
            return P("model", None)                   # vocab-parallel
        if "blocks" not in name:
            return P()                                # final_norm
        if name.endswith(("ln1", "ln2", "q_norm", "k_norm", "kv_norm")):
            return P(None, None)
        if name.endswith(("attn/wq", "attn/wk", "attn/wv", "attn/w_uk",
                          "attn/w_uv", "ffn/w_gate", "ffn/w_up",
                          "ffn/shared_w_in")):
            return P(None, None, "model")             # column parallel
        if name.endswith(("attn/wo", "ffn/w_down", "ffn/shared_w_out")):
            return P(None, "model", None)             # row parallel
        if name.endswith(("attn/w_dkv", "attn/w_k_rope", "ffn/router")):
            return P(None, None, None)
        if name.endswith(("ffn/w_in", "ffn/w_out")):  # (L, E, d, 2f) / (L, E, f, d)
            return (P(None, "model", "data", None) if moe_2d
                    else P(None, "model", None, "data"))
        return P(*([None] * nd))

    return _map_with_path(rule, params_shape)


def gnn_param_specs(params_shape, mesh) -> Any:
    """Every GNN parameter replicated (tiny); the edges carry the split."""
    return replicated(params_shape)


# ---------------------------------------------------------------------------
# RecSys params
# ---------------------------------------------------------------------------

def recsys_param_specs(params_shape, mesh) -> Any:
    def rule(name: str, leaf) -> P:
        nd = len(leaf.shape)
        big_table = ("table" in name or name == "embed" or
                     name.startswith("sparse_tables"))
        if big_table and nd == 2 and leaf.shape[0] >= 8192:
            # rows on `model` only (replicated over data): the row-sharded
            # lookups gather locally + sum the reduced bag over `model`;
            # ZeRO shards the optimizer moments over data
            return P("model", None)
        if "blocks" in name or "seq_blocks" in name:
            # recsys sequence encoders are TINY (d<=128, <=4 heads):
            # replicated, the batch is split over (data x model) instead
            return P(*([None] * nd))
        if nd == 2 and leaf.shape[0] * leaf.shape[1] >= (1 << 22):
            return P(None, "model")                  # big dense MLP layers
        return P(*([None] * nd))

    return _map_with_path(rule, params_shape)


def replicated(params_shape) -> Any:
    """Every leaf whole on every rank: ``P(None, ...)`` a dim."""
    return tree_map(lambda l: P(*([None] * len(l.shape))), params_shape)


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` as DTensor placements on ``mesh``: one
    ``Shard(dim)`` or ``Replicate()`` per mesh dim."""
    names = all_axes_of(mesh)

    def placements(spec: P):
        out = [Replicate()] * len(names)
        for dim in range(len(spec)):
            for a in spec.dim_axes(dim):
                out[names.index(a)] = Shard(dim)
        return tuple(out)

    return tree_map(placements, spec_tree, is_leaf=is_spec)


def local_shape(shape: Tuple[int, ...], spec: P, mesh) -> Tuple[int, ...]:
    """One rank's block shape of a global ``shape`` under ``spec``."""
    out = []
    for dim, n in enumerate(shape):
        k = axes_size(mesh, spec.dim_axes(dim))
        if n % k:
            raise ValueError(f"dim {dim} of {shape} does not split over "
                             f"{spec.dim_axes(dim)} ({k} ranks)")
        out.append(n // k)
    return tuple(out)


def local_block(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec`` (a view;
    row-major over each dim's axes, as ``jax.sharding`` lays it out)."""
    for dim in range(min(len(spec), x.ndim)):
        axes = spec.dim_axes(dim)
        if axes:
            n = x.shape[dim] // axes_size(mesh, axes)
            x = x.narrow(dim, axes_rank(mesh, axes) * n, n)
    return x
