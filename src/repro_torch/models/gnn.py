"""MeshGraphNet (encode-process-decode, arXiv:2010.03409) in plain PyTorch.

Port of ``repro.models.gnn``. Message passing sums each edge's message
into its receiver with ``index_add`` into a zero (N, h) block, where the
reference calls ``jax.ops.segment_sum``; on the card ``index_add`` adds
with atomics, so card results hold to a tolerance, not to bytes. Blocks are
stacked on axis 0 (``layers.stack_blocks``) and run in a loop, each under
``torch.utils.checkpoint`` when ``cfg.remat`` is set and gradients are on;
``scan_blocks`` is the reference's field, kept so the configs are equal.

A padded (masked) edge's state is zero in the forward pass of both
packages: its message is masked and ``_ln`` of a zero row is zero. The
port masks the edge state after each block's ``_ln`` too, which leaves the
forward values as they are and stops the gradient there. In the reference
a masked row still receives the aggregation's gradient, and each block's
``_ln`` backward at zero variance multiplies it by ``1/sqrt(eps)`` = 1000:
over the 15 FULL blocks it overflows, and the masked product turns the
``inf`` into NaN gradients for every parameter (a fault of the reference,
kept there). Where the reference's gradients are finite, the two agree.

On a mesh of more than one rank (``parallel.tp``) ``forward`` and
``loss_fn`` are the rank-local program of the reference's vertex-cut
placement: the edge arrays are this rank's block of the padded edges, the
nodes and parameters are whole on every rank. Each rank encodes and
updates its own edges, adds their messages into a zero (N, h) block, and
the blocks are summed over every axis before the (replicated) node MLP;
the loss is this rank's share, ``1 / ranks``, of the global loss
(``models.parallel``'s convention).

Includes the reference's fanout neighbor sampler (numpy, host side) for
the ``minibatch_lg`` regime: the same ``np.random.Generator`` state gives
the same arrays byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import parallel as PL
from repro_torch.models.embedding import mlp_apply, mlp_init
from repro_torch.tree import to_parameter_dict, tree_leaves

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 16
    d_edge_in: int = 8
    d_out: int = 3
    aggregator: str = "sum"
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    scan_blocks: bool = True

    def param_count(self) -> int:
        """Parameters, counted from shapes on the ``meta`` device."""
        return sum(t.numel() for t in tree_leaves(init(self, device="meta")))


def _mlp_dims(d_in: int, d_hidden: int, n_layers: int, d_out: int):
    return [d_in] + [d_hidden] * (n_layers - 1) + [d_out]


def init(cfg: MeshGraphNetConfig, seed: int = 0, device="cuda"):
    """Random float32 parameters from ``seed`` in the reference's tree
    layout, blocks stacked on axis 0."""
    gen = L.generator(device, seed)
    h, m = cfg.d_hidden, cfg.mlp_layers

    def block_init():
        return {
            # edge update: MLP([e, h_src, h_dst])
            "edge_mlp": mlp_init(gen, _mlp_dims(3 * h, h, m, h), device=device),
            # node update: MLP([h, agg_msgs])
            "node_mlp": mlp_init(gen, _mlp_dims(2 * h, h, m, h), device=device),
            "edge_ln": torch.ones((h,), device=device),
            "node_ln": torch.ones((h,), device=device),
        }

    return to_parameter_dict({
        "node_encoder": mlp_init(gen, _mlp_dims(cfg.d_node_in, h, m, h),
                                 device=device),
        "edge_encoder": mlp_init(gen, _mlp_dims(cfg.d_edge_in, h, m, h),
                                 device=device),
        "blocks": L.stack_blocks(cfg.n_layers, block_init),
        "decoder": mlp_init(gen, _mlp_dims(h, h, m, cfg.d_out),
                            device=device),
    })


def _ln(x: torch.Tensor, w: torch.Tensor, eps=1e-6) -> torch.Tensor:
    """LayerNorm in float32 at least (a float64 state stays float64)."""
    dt = x.dtype
    x32 = x.to(torch.promote_types(dt, torch.float32))
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.var(x32, -1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * w.to(x32.dtype)).to(dt)


def _block(cfg: MeshGraphNetConfig, senders, receivers, edge_mask, h, e, bp,
           mesh=None):
    m = cfg.mlp_layers
    msg_in = torch.cat([e, h[senders], h[receivers]], dim=-1)
    e_new = mlp_apply(bp["edge_mlp"], msg_in, m)
    if edge_mask is not None:
        e_new = e_new * edge_mask[:, None].to(e_new.dtype)
    e = _ln(e + e_new, bp["edge_ln"])
    if edge_mask is not None:    # zero already: stops the gradient (above)
        e = e * edge_mask[:, None].to(e.dtype)
    agg = torch.zeros((h.shape[0], e.shape[1]), dtype=e.dtype,
                      device=e.device).index_add(0, receivers, e)
    if PL.tp(mesh):
        agg = PL.sum_over(agg, mesh, mesh.mesh_dim_names)
    h_new = mlp_apply(bp["node_mlp"], torch.cat([h, agg], dim=-1), m)
    return _ln(h + h_new, bp["node_ln"]), e


def forward(
    params: Params,
    node_feats: torch.Tensor,    # (N, d_node_in)
    edge_feats: torch.Tensor,    # (E, d_edge_in)
    senders: torch.Tensor,       # (E,) int
    receivers: torch.Tensor,     # (E,) int
    cfg: MeshGraphNetConfig,
    edge_mask: Optional[torch.Tensor] = None,   # (E,) for padded edges
    mesh=None,
) -> torch.Tensor:
    dt = cfg.compute_dtype
    m = cfg.mlp_layers
    senders, receivers = senders.long(), receivers.long()
    h = mlp_apply(params["node_encoder"], node_feats.to(dt), m)
    e = mlp_apply(params["edge_encoder"], edge_feats.to(dt), m)
    if edge_mask is not None:
        e = e * edge_mask[:, None].to(dt)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in L.unstack(params["blocks"], cfg.n_layers):
        args = (cfg, senders, receivers, edge_mask, h, e, bp, mesh)
        h, e = (checkpoint(_block, *args, use_reentrant=False) if remat
                else _block(*args))
    return mlp_apply(params["decoder"], h, m)


def loss_fn(params, node_feats, edge_feats, senders, receivers, targets,
            cfg: MeshGraphNetConfig, node_mask=None, edge_mask=None,
            mesh=None) -> torch.Tensor:
    pred = forward(params, node_feats, edge_feats, senders, receivers, cfg,
                   edge_mask, mesh)
    err = (pred.float() - targets.float()) ** 2
    if node_mask is not None:
        err = err * node_mask[:, None]
        loss = torch.sum(err) / (torch.clamp(torch.sum(node_mask), min=1)
                                 * cfg.d_out)
    else:
        loss = torch.mean(err)
    return loss / mesh.size() if PL.tp(mesh) else loss


# ---------------------------------------------------------------------------
# Neighbor sampler (host-side, for minibatch_lg): fanout-(f1, f2) sampling
# ---------------------------------------------------------------------------

class CSRGraph:
    """Host-side CSR adjacency for sampling."""

    def __init__(self, n_nodes: int, senders: np.ndarray, receivers: np.ndarray):
        self.n_nodes = n_nodes
        order = np.argsort(receivers, kind="stable")
        self.src_sorted = senders[order]
        self.indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        counts = np.bincount(receivers, minlength=n_nodes)
        np.cumsum(counts, out=self.indptr[1:])

    def neighbors(self, v: int) -> np.ndarray:
        return self.src_sorted[self.indptr[v] : self.indptr[v + 1]]


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanouts: Tuple[int, ...],
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """GraphSAGE-style fixed-fanout sampling producing FIXED-SHAPE padded
    arrays: layer l samples ``fanouts[l]`` in-neighbors per frontier slot,
    so hop l contributes exactly batch * prod(fanouts[:l+1]) edges; empty
    slots are masked out. Frontier slots keep duplicates, so every
    minibatch has one shape."""
    frontier = seeds.astype(np.int64)
    frontier_mask = np.ones(len(frontier), dtype=bool)
    all_src, all_dst, all_mask = [], [], []
    for f in fanouts:
        n_f = len(frontier)
        src = np.zeros((n_f, f), dtype=np.int64)
        msk = np.zeros((n_f, f), dtype=bool)
        for i, v in enumerate(frontier):
            if not frontier_mask[i]:
                continue
            nbr = graph.neighbors(int(v))
            if len(nbr) == 0:
                continue
            take = rng.choice(nbr, size=f, replace=len(nbr) < f)
            src[i] = take
            msk[i] = True
        all_src.append(np.where(msk.reshape(-1), src.reshape(-1), 0))
        all_dst.append(np.repeat(frontier, f))
        all_mask.append(msk.reshape(-1))
        frontier = src.reshape(-1)
        frontier_mask = msk.reshape(-1)

    senders = np.concatenate(all_src)
    receivers = np.concatenate(all_dst)
    edge_mask = np.concatenate(all_mask)
    # compact node ids
    nodes, inv = np.unique(np.concatenate([senders, receivers, seeds]),
                           return_inverse=True)
    senders_c = inv[: len(senders)]
    receivers_c = inv[len(senders) : 2 * len(senders)]
    seed_local = inv[2 * len(senders):]
    return {
        "nodes": nodes,
        "senders": senders_c.astype(np.int32),
        "receivers": receivers_c.astype(np.int32),
        "edge_mask": edge_mask,
        "seed_local": seed_local.astype(np.int32),
    }
