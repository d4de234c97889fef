"""Model FLOPs of a training example, counted from the plain reference.

``torch.utils.flop_counter`` counts the products (matrix products and
attention's two batched products) of one microbatch's forward and backward
pass through the reference, on the ``meta`` device: shapes only, no memory,
no time on the card. Nothing is recomputed in the reference, so the count
is the model's, whatever the program recomputes.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.reference.precision import STATED


def per_example(ref, cfg: dict, rows: int, seq_len: int) -> float:
    """FLOPs of one example's forward and backward pass: ``ref`` is a
    reference module (``layout``, ``meta_inputs``, ``loss``)."""
    params = {}
    for path, shape, _ in ref.layout(cfg):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(shape, device="meta", requires_grad=True)
    batch = ref.meta_inputs(cfg, rows, seq_len)
    with FlopCounterMode(display=False) as counter:
        ref.loss(params, batch, cfg, STATED).backward()
    return counter.get_total_flops() / rows
