"""Plain reference of the training step, followed for a few steps.

A step splits its batch into ``accum`` consecutive row blocks, sums each
block's float32 gradients and divides by ``accum`` (the loss is the mean of
the blocks' losses), then takes an AdamW step (``reference.adamw``). The
readings compared with the program's are each step's loss, each leaf's norm
of the first gradient as the optimizer takes it (worked out from the first
moment after one step, ``m / (1 - beta1)``), and each leaf's norm of the
parameters' change after the last step.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from bench.reference import weights as W
from bench.reference import adamw
from bench.reference.precision import Precision


def follow(ref, cfg: dict, seed: int, device, batches: List[Dict],
           accum: int, opt: adamw.AdamW, P: Precision,
           half: bool = False) -> Dict[str, List[float]]:
    """Draw the weights of ``seed``, train ``len(batches)`` steps of the
    reference module ``ref`` on model inputs ``batches`` (already prepared
    with ``ref.prep``), and return the readings. ``half`` plants a fault:
    each block's loss is the mean over its first half of rows."""
    layout = ref.layout(cfg)
    _, drawn = W.draw(layout, seed, device)
    tree = W.as_parameters(drawn)
    params = W.leaves(tree)
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    out = {"loss": [], "grad_norm": [], "change_norm": []}
    for t, batch in enumerate(batches, start=1):
        for p in params:
            p.grad = None
        lsum = torch.zeros((), device=device)
        b = next(iter(batch.values())).shape[0]
        rows = b // accum
        for i in range(accum):
            keep = rows // 2 if half else rows
            mb = {k: x[i * rows:i * rows + keep] for k, x in batch.items()}
            loss = ref.loss(tree, mb, cfg, P)
            loss.backward()
            lsum += loss.detach().float()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.float()
                 for p in params]
        for p, g in zip(params, grads):
            p.grad = None
            g.div_(accum)
        adamw.step(opt, t, params, grads, m, v)
        del grads
        out["loss"].append(float(lsum / accum))
        if t == 1:
            out["grad_norm"] = leaf_norms(m, 1.0 / (1.0 - opt.beta1))
    _, start = W.draw(layout, seed, device)
    out["change_norm"] = change_norms(params, W.leaves(start))
    return out


@torch.no_grad()
def leaf_norms(leaves, scale: float = 1.0) -> List[float]:
    norms = torch.stack([torch.linalg.vector_norm(x.float()) for x in leaves])
    return (norms * scale).tolist()


CHUNK = 1 << 26          # elements a block of ``change_norms``


@torch.no_grad()
def change_norms(now, start) -> List[float]:
    """Each leaf's norm of ``now - start``, ``CHUNK`` elements at a time, so
    that no temporary outgrows a block; ``start`` may sit on the host."""
    out = []
    for a, b in zip(now, start):
        a, b = a.reshape(-1), b.reshape(-1)
        sq = torch.zeros((), dtype=torch.float64, device=a.device)
        for i in range(0, a.numel(), CHUNK):
            d = a[i:i + CHUNK].float() - b[i:i + CHUNK].to(a.device).float()
            sq += torch.linalg.vector_norm(d).double() ** 2
        out.append(sq.sqrt())
    return torch.stack(out).tolist()
