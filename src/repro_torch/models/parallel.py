"""Collectives of the zoo's rank-local programs, with their adjoints.

Eager PyTorch has no SPMD partitioner, so every placement of the
reference's GSPMD program is code here: a model function given a mesh of
more than one rank (``tp(mesh)``) computes this rank's block and crosses
ranks through these functions.

The gradient convention (one for the whole port). A rank's loss is its
SHARE of the global loss: ranks that compute the same loss redundantly
(every ``model`` rank of an LM, every rank of a GNN, the data ranks of a
batch that is not split over them) each take ``1 / (their count)``, so the
global loss is the sum of the ranks' losses. Every collective's backward is
its adjoint: an all-reduce's is an all-reduce, an all-gather's a
reduce-scatter. Autograd then gives each rank the gradient of that sum
with respect to its own tensors: a sharded weight its exact block, a
replicated one (norms, the router, MLA's ``w_dkv``) a partial sum that
``launch.steps._sharded_train_step`` completes by summing over the axes
the weight is replicated on. (Megatron's "identity in backward" operators
would instead hand every ``model`` rank the full gradient of a replicated
weight, and that sum would count it ``model`` times.)

Each collective is a ``torch.autograd.Function`` around a
``torch.distributed._functional_collectives`` call, so the fake process
group of the dry run traces it and ``roofline.step_counts`` counts it. A
collective over one rank is the identity and dispatches nothing.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.launch.mesh import (
    axes_group,
    axes_rank,
    axes_size,
    subaxis_group,
)


def tp(mesh) -> bool:
    """Whether ``mesh`` asks for the rank-local program (more than one
    rank); a mesh of one rank runs the single-device one."""
    return mesh is not None and mesh.size() > 1


def _axes(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    """``axes`` in the mesh's order (a group, a block and a rank over
    several axes are row-major in that order)."""
    return tuple(a for a in mesh.mesh_dim_names if a in tuple(axes))


def _sync(t: torch.Tensor) -> torch.Tensor:
    if isinstance(t, funcol.AsyncCollectiveTensor):
        return t.wait()
    return t


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sync(funcol.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        return _sync(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), \
            None


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _sync(funcol.all_gather_tensor(x.contiguous(), dim, group))

    @staticmethod
    def backward(ctx, g):
        return _sync(funcol.reduce_scatter_tensor(
            g.contiguous(), "sum", ctx.dim, ctx.group)), None, None


def sum_over(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """All-reduce (sum) over ``axes``; its backward is an all-reduce."""
    axes = _axes(mesh, axes)
    if axes_size(mesh, axes) == 1:
        return x
    return _SumOver.apply(x, axes_group(mesh, axes))


def max_over(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """All-reduce (max) over ``axes``, outside autograd (a shift that the
    gradient does not see, as ``logsumexp``'s max)."""
    axes = _axes(mesh, axes)
    x = x.detach()
    if axes_size(mesh, axes) == 1:
        return x
    return _sync(funcol.all_reduce(x.contiguous(), "max",
                                   axes_group(mesh, axes)))


def gather_over(x: torch.Tensor, dim: int, mesh, axes: Sequence[str]
                ) -> torch.Tensor:
    """All-gather along ``dim`` over ``axes`` (blocks in the axes'
    row-major rank order); its backward is a reduce-scatter."""
    axes = _axes(mesh, axes)
    if axes_size(mesh, axes) == 1:
        return x
    return _GatherOver.apply(x, dim % x.ndim, axes_group(mesh, axes))


def gather_within(x: torch.Tensor, dim: int, mesh, axis: str, inner: int
                  ) -> torch.Tensor:
    """All-gather along ``dim`` over the ``inner`` consecutive ranks of
    ``axis`` that hold this rank (``launch.mesh.subaxis_group``)."""
    if inner == 1:
        return x
    return _GatherOver.apply(x, dim % x.ndim,
                             subaxis_group(mesh, axis, inner))


def block(x: torch.Tensor, dim: int, mesh, axes: Sequence[str]
          ) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (a view, no
    communication): the slice a rank keeps of a value replicated over
    them."""
    axes = _axes(mesh, axes)
    n = axes_size(mesh, axes)
    if n == 1:
        return x
    k = x.shape[dim] // n
    return x.narrow(dim, axes_rank(mesh, axes) * k, k)


def rank_of(mesh, axes: Sequence[str]) -> int:
    return axes_rank(mesh, _axes(mesh, axes))


def size_of(mesh, axes: Sequence[str]) -> int:
    return axes_size(mesh, _axes(mesh, axes))


def columns_to_positions(x: torch.Tensor, mesh, model_axis: str,
                         seq_axes: Tuple[str, ...]) -> torch.Tensor:
    """A (B, S, C) value of every position whose columns are blocked over
    ``model_axis`` (this rank holds its block of C) re-blocked by
    position: (B, S / n, C * model) for this rank's block of ``seq_axes``
    (row-major, ``model_axis`` last). The positions of the other seq axes
    are a slice (the value is the same on those ranks); those of
    ``model_axis`` an all-to-all, which no gradient crosses (prefill's
    cache)."""
    outer = tuple(a for a in seq_axes if a != model_axis)
    x = block(x, 1, mesh, outer)
    m = axes_size(mesh, (model_axis,))
    if m == 1:
        return x
    b, s, c = x.shape
    # (m, B, S/m, C): chunk j goes to model rank j
    send = x.reshape(b, m, s // m, c).permute(1, 0, 2, 3).contiguous()
    got = _sync(funcol.all_to_all_single(
        send.reshape(m * b * (s // m), c), None, None,
        axes_group(mesh, (model_axis,))))
    # from rank i: its columns of my positions
    got = got.reshape(m, b, s // m, c).permute(1, 2, 0, 3)
    return got.reshape(b, s // m, m * c)


def softmax_partials(scores: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(max, exp(scores - max), sum) over the last axis of float32
    ``scores``: one rank's part of a softmax whose axis is sharded."""
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    return m, e, e.sum(dim=-1, keepdim=True)


def merge_partials(m: torch.Tensor, s: torch.Tensor, o: torch.Tensor,
                   mesh, axes: Sequence[str], m_to_o
                   ) -> torch.Tensor:
    """The log-sum-exp combine of attention partials over ``axes``: each
    rank's running max ``m`` and sum ``s`` (score layout) and unnormalized
    output ``o``; ``m_to_o`` maps a score-layout tensor onto ``o``'s
    layout. Returns the normalized output in float32."""
    big = max_over(m, mesh, axes)
    w = torch.exp(m - big)
    total = sum_over(s * w, mesh, axes)
    out = sum_over(o.float() * m_to_o(w), mesh, axes)
    return out / m_to_o(total)
