"""Parameter trees in JAX's flatten order.

The port keeps the reference's parameter layout: nested dicts (``dict`` or
``nn.ParameterDict``) of tensors, with tuples such as ``AdamWState`` as
inner nodes. ``jax.tree_util`` flattens a dict in SORTED key order and a
tuple in field order, and the checkpoint format numbers leaves in that
order, so every walk over a tree here uses the same order.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch
from torch import nn


def _is_dict(x: Any) -> bool:
    return isinstance(x, (dict, nn.ParameterDict))


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order (``None`` has none)."""
    if tree is None:
        return []
    if _is_dict(tree):
        return [leaf for k in sorted(tree.keys())
                for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``). Dict nodes become plain dicts in sorted key order; tuples keep
    their type (NamedTuples included)."""
    if tree is None:
        return None
    if _is_dict(tree):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree.keys())}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, x, *(r[i] for r in rest))
                 for i, x in enumerate(tree)]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree, *rest)


def to_parameter_dict(tree: Any) -> nn.ParameterDict:
    """A nested dict of tensors as a nested ``nn.ParameterDict`` (leaves
    become trainable ``nn.Parameter``s; insertion order is sorted). Tensor
    leaves are wrapped without a copy; other leaves (numpy) are copied."""
    out = nn.ParameterDict()
    for k in sorted(tree.keys()):
        v = tree[k]
        if _is_dict(v):
            out[k] = to_parameter_dict(v)
        else:
            out[k] = nn.Parameter(v if isinstance(v, torch.Tensor)
                                  else torch.tensor(v))
    return out
