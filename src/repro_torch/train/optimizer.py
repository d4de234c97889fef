"""AdamW + schedules on trees of tensors (no ``torch.optim``).

Port of ``repro.train.optimizer``: the reference's linear-warmup + cosine
schedule, global-norm clip and ``ndim >= 2`` decay mask, with m/v in
float32. Scalars (learning rate, bias corrections) are computed in float32
as the reference computes them. ``adamw_update`` updates parameters, m and v
IN PLACE: at the full DLRM-UIH width the item table alone is 5.1 GB, and a
functional update would hold a second copy of every leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any                   # tree like params (float32)
    v: Any


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def lr_schedule(step: int, cfg: AdamWConfig) -> np.float32:
    """Linear warmup + cosine decay to min_lr_ratio (float32 arithmetic)."""
    f32 = np.float32
    step = f32(step)
    warm = min(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    prog = np.clip((step - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
    decay = f32(cfg.min_lr_ratio) + (f32(1) - f32(cfg.min_lr_ratio)) * cos
    return f32(cfg.lr) * warm * decay


def global_norm(tree) -> torch.Tensor:
    total = None
    for x in tree_leaves(tree):
        sq = torch.linalg.vector_norm(x, dtype=torch.float32).square()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-9))``, in place."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def adamw_update(
    params, grads, state: AdamWState, cfg: AdamWConfig,
    decay_mask: Optional[Any] = None,
) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step. ``grads`` is a float32 tree like ``params`` and is
    clipped in place; params, m and v are updated in place and returned."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = int(state.step) + 1
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
    p_leaves = tree_leaves(params)
    if decay_mask is None:
        # decay matrices only (ndim >= 2), not norms/biases — standard practice
        wd_on = [float(p.ndim >= 2) for p in p_leaves]
    else:
        wd_on = [float(x) for x in tree_leaves(decay_mask)]
    for p, g, m, v, wd in zip(p_leaves, tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v),
                              wd_on):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay:
            u.add_(p.float(), alpha=cfg.weight_decay * wd)
        p.sub_(u.mul_(float(lr)).to(p.dtype))
    new_state = AdamWState(step=torch.full_like(state.step, step),
                           m=state.m, v=state.v)
    return params, new_state, {"grad_norm": gnorm, "lr": float(lr)}
