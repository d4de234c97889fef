"""AdamW + schedules on trees of tensors (no ``torch.optim``).

Port of ``repro.train.optimizer``: the reference's linear-warmup + cosine
schedule, global-norm clip and ``ndim >= 2`` decay mask, with m/v in
float32. Scalars (learning rate, bias corrections) are computed in float32
as the reference computes them. ``adamw_update`` updates parameters, m and v
IN PLACE: at the full DLRM-UIH width the item table alone is 5.1 GB, and a
functional update would hold a second copy of every leaf. The update itself
is ``kernels.adamw``: two launches over every leaf on the card (the
reference's global-norm clip and per-leaf arithmetic, fused), its plain
per-leaf passes on the CPU.
``make_train_step`` builds the reference's generic step: gradients of any
``loss_fn(params, batch)``, optional compression, AdamW.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.adamw import LeafTable, adamw
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


@torch.no_grad()
def adamw_update(
    params, grads, state: AdamWState, cfg: AdamWConfig,
    decay_mask: Optional[Any] = None, gnorm: Optional[torch.Tensor] = None,
    grad_scale: float = 1.0, table: Optional[LeafTable] = None,
) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step. ``grads`` is a float32 tree like ``params``, taken
    times ``grad_scale`` (``Trainer`` hands the sum over its n microbatches
    and 1/n) and clipped by its global norm; params, m and v are updated in
    place and returned. ``gnorm`` is the norm of ``grads`` as handed when
    the caller took it over shards held by other ranks (default: taken
    here). The stats' ``grad_norm`` is the norm of the scaled gradients.
    ``table`` is the kernel's leaf table, kept by the caller beside the
    state and handed to each of its steps (default: one for this step).

    One ``kernels.adamw`` call over every leaf: the multi-tensor kernel for
    CUDA leaves, which reads the gradients and never writes them, or its
    plain per-leaf version for CPU leaves, which scales and clips them in
    place. Either way ``grads`` is spent: no caller reads it afterwards."""
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
    gnorm = adamw(p_leaves, tree_leaves(grads), tree_leaves(state.m),
                  tree_leaves(state.v), [cfg.weight_decay * w for w in wd_on],
                  lr=float(lr), beta1=b1, beta2=b2, bc1=bc1, bc2=bc2,
                  eps=cfg.eps, clip=cfg.grad_clip, grad_scale=grad_scale,
                  gnorm=gnorm, table=table)
    new_state = AdamWState(step=torch.full_like(state.step, step),
                           m=state.m, v=state.v)
    return params, new_state, {"grad_norm": gnorm, "lr": float(lr)}


def tree_grads(loss: torch.Tensor, params) -> Any:
    """float32 gradients of ``loss`` for every leaf of ``params``, as a tree
    like it (zeros for a leaf the loss does not reach)."""
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p, dtype=torch.float32) if g is None
               else g.float() for p, g in zip(leaves, grads)])
    return tree_map(lambda _: next(it), params)


def make_train_step(
    loss_fn: Callable[..., torch.Tensor],
    cfg: AdamWConfig,
    compress: Optional[Callable] = None,
):
    """Generic train step: gradients + optional gradient compression +
    AdamW. ``loss_fn(params, batch) -> scalar``; the step returns
    ``(params, opt_state, {"loss", "grad_norm", "lr"})`` with the
    parameters and moments updated in place. Leaves that do not require
    gradients are switched to require them."""
    table = LeafTable()

    def train_step(params, opt_state: AdamWState, batch):
        for p in tree_leaves(params):
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = tree_grads(loss, params)
        if compress is not None:
            grads = compress(grads)
        params, opt_state, stats = adamw_update(params, grads, opt_state, cfg,
                                                table=table)
        return params, opt_state, {"loss": loss.detach(), **stats}

    return train_step
