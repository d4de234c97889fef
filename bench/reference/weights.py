"""Weights made from the seed, on the device, in one draw.

Every parameter of a layout is a view into one float32 buffer filled by a
single ``torch.randn`` from a ``torch.Generator`` on the device; each view
is then scaled, zeroed or set to one in place. The same seed and layout
give the same weights, so the reference draws them again instead of taking
the program's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn


def draw(layout, seed: int, device) -> Tuple[torch.Tensor, Dict]:
    """(flat buffer, nested dict of its views) for ``layout``'s
    (path, shape, init) entries."""
    total = sum(math.prod(shape) for _, shape, _ in layout)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    off = 0
    with torch.no_grad():
        for _, shape, init in layout:
            n = math.prod(shape)
            leaf = flat[off:off + n]
            off += n
            if init[0] == "normal":
                leaf.mul_(init[1])
            elif init[0] == "zeros":
                leaf.zero_()
            else:
                leaf.fill_(1.0)
    return flat, split(flat, layout)


def split(flat: torch.Tensor, layout) -> Dict:
    """The nested dict of ``layout``'s leaves as views into ``flat``."""
    tree: Dict = {}
    off = 0
    for path, shape, _ in layout:
        n = math.prod(shape)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[off:off + n].view(shape)
        off += n
    return tree


def leaves(tree) -> List[torch.Tensor]:
    """Leaves in sorted-key order (the layouts' and the port's order)."""
    if isinstance(tree, (dict, nn.ParameterDict)):
        return [x for k in sorted(tree.keys()) for x in leaves(tree[k])]
    return [tree]


def as_parameters(tree) -> nn.ParameterDict:
    """The nested dict as nested ``nn.ParameterDict``s of trainable leaves
    that share the buffer's memory."""
    out = nn.ParameterDict()
    for k in sorted(tree.keys()):
        v = tree[k]
        out[k] = as_parameters(v) if isinstance(v, dict) else nn.Parameter(v)
    return out


def leaf_names(layout) -> List[str]:
    return ["/".join(path) for path, _, _ in layout]
