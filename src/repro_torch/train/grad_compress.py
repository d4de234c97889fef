"""Int8 gradient compression with error feedback.

Port of ``repro.train.grad_compress``, bit-exact: each leaf is quantized to
int8 with a per-leaf max-abs scale; the quantization residual is carried in
an error-feedback buffer and added to the next step's gradient, making the
compression unbiased over time (EF-SGD/1-bit-Adam family). Wire-format bytes
drop 4x vs fp32.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class EFState(NamedTuple):
    residual: Any     # tree like grads (fp32)


def ef_init(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grads, state: EFState) -> Tuple[Any, EFState]:
    """Returns (decompressed grads as the optimizer sees them, new EF state)."""
    g32 = tree_map(lambda g, r: g.float() + r, grads, state.residual)
    deq = tree_map(lambda x: dequantize_int8(*quantize_int8(x)), g32)
    return deq, EFState(residual=tree_map(torch.sub, g32, deq))


def wire_bytes(grads, compressed: bool) -> int:
    """Bytes a pod-level all-reduce moves per step (for the benchmarks)."""
    total = 0
    for g in tree_leaves(grads):
        n = g.numel()
        total += n * (1 if compressed else 4) + (4 if compressed else 0)
    return total
