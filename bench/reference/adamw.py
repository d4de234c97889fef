"""Plain reference of the optimizer: AdamW with linear warm-up and cosine
decay, clipping by the global norm, weight decay on matrices only.

A frozen copy of the port's ``train/optimizer.py``: moments in float32,
the schedule and bias corrections in float32 arithmetic, parameters, m
and v updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    warmup_steps: int
    total_steps: int
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    min_lr_ratio: float = 0.1

    def lr_at(self, step: int) -> np.float32:
        f32 = np.float32
        s = f32(step)
        warm = min(s / f32(max(self.warmup_steps, 1)), f32(1.0))
        prog = np.clip((s - f32(self.warmup_steps))
                       / f32(max(self.total_steps - self.warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
        decay = f32(self.min_lr_ratio) + (f32(1) - f32(self.min_lr_ratio)) * cos
        return f32(self.lr) * warm * decay


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    total = None
    for g in grads:
        sq = torch.linalg.vector_norm(g, dtype=torch.float32).square()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def step(cfg: AdamW, t: int, params: List[torch.Tensor],
         grads: List[torch.Tensor], m: List[torch.Tensor],
         v: List[torch.Tensor]) -> List[torch.Tensor]:
    """Step ``t`` (from 1): clip ``grads`` in place, update ``m``, ``v`` and
    ``params`` in place. Returns the clipped gradients."""
    norm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (norm + 1e-9), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    lr = float(cfg.lr_at(t))
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (mi / bc1).div_((vi / bc2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay:
            u.add_(p.float(), alpha=cfg.weight_decay * float(p.ndim >= 2))
        p.sub_(u.mul_(lr).to(p.dtype))
    return grads
