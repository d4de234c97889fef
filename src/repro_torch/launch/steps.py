"""Cell builders: (arch x shape x mesh) -> step function + input specs +
placements.

Port of ``repro.launch.steps``. ``args_spec`` holds ``S`` records (shape,
dtype), never allocated tensors: ``launch.sampling`` makes real inputs from
them and ``launch.dryrun`` makes fake ones.

Eager PyTorch has no SPMD partitioner, so a cell's ``step_fn`` is the
rank-local program: it takes this rank's block of every argument (as
``shardings.local_block`` cuts it) and returns its block of the outputs. On
a mesh of one device every block is the whole tensor and the placements are
identities, so the cell's arrays are plain tensors on that device and its
config keeps ``mesh=None``: the model takes its single-device path and no
collective or DTensor dispatch runs. On a larger mesh the train and serve
cells set the config's ``mesh`` and ``data_axes`` (row-sharded lookups,
the batch split over data x model for the encoders), the retrieval cells
set ``data_axes`` to every axis (their candidates are sharded over all of
them), and the train step reduces each gradient over the axes its
parameter is replicated on and updates ZeRO-sharded moments on this rank's
slice (``_sharded_train_step``).

The LM and GNN cells carry the reference's placements
(``shardings.lm_param_specs``, ``gnn_param_specs``) and pass the mesh to
the model functions, which run their rank-local programs on a mesh of more
than one rank (``models.parallel``): Megatron tensor parallelism and a
vocabulary-parallel embedding and loss over ``model``, the MoE's experts
over ``model`` (FSDP over ``data``, or the ``2d`` layout the decode cells
switch to), a decode cache blocked by position, a GNN's edges over every
axis. Their train cells use the same ``_sharded_train_step``: each rank's
loss is its share of the global loss and every collective's backward is
its adjoint, so each gradient is a partial sum that the step completes
over the axes its parameter is replicated on. On a one-rank mesh the
model functions take their single-device paths (an MoE runs its
``shard_map`` bodies as rank 0).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchSpec
from repro_torch.kernels.adamw import LeafTable
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import (
    all_axes_of,
    axes_group,
    axes_rank,
    axes_size,
    data_axes_of,
)
from repro_torch.launch.shardings import P
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    make_train_step,
    tree_grads,
)
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class S:
    """A shape and dtype: an argument's spec (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    step_fn: Callable          # positional args (rank-local blocks)
    args_spec: Tuple[Any, ...] # S trees (positional, global shapes)
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    model_flops: float         # 6ND-style useful flops for this step
    meta: Dict[str, Any]


def eval_shape(fn: Callable[[], Any]) -> Any:
    """The ``S`` tree of what ``fn()`` returns, allocating nothing (it runs
    under ``FakeTensorMode``)."""
    with FakeTensorMode():
        out = fn()
    return tree_map(lambda t: S(tuple(t.shape), t.dtype), out)


def _div(b: int, axes_size_: int) -> bool:
    return b % axes_size_ == 0 and b >= axes_size_


def _batch_axes(mesh, b: int):
    da = data_axes_of(mesh)
    return (da if _div(b, axes_size(mesh, da)) else None), da


def _adamw_shape(pshape) -> AdamWState:
    return AdamWState(step=S((), torch.int32),
                      m=tree_map(lambda l: S(l.shape, torch.float32), pshape),
                      v=tree_map(lambda l: S(l.shape, torch.float32), pshape))


def _bf16(pshape):
    """Serving holds bf16 weights (no float32 master)."""
    return tree_map(lambda l: S(l.shape, torch.bfloat16)
                    if l.dtype.is_floating_point else l, pshape)


def _no_grad(fn: Callable) -> Callable:
    """A serving step: no autograd graph."""
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def build_lm_cell(spec: ArchSpec, shape_name: str, mesh,
                  use_full: bool = True, cfg_override=None) -> Cell:
    cfg = cfg_override or (spec.full if use_full else spec.smoke)
    shp = spec.shapes[shape_name]
    b, sl = shp["batch"], shp["seq_len"]
    if not use_full:  # smoke: shrink shapes
        b, sl = max(2, b // 128), min(sl, 64)
    b_axes, _ = _batch_axes(mesh, b)
    # the axes the batch is split on (none where it does not split): the
    # reference's moe_data_axes, and its data axes for every train and
    # prefill cell (their batches split)
    da = b_axes or ()
    kind = shp["kind"]
    if cfg.moe is not None and kind == "decode":
        # decode: fully-resident 2D expert layout (no per-step all-gather)
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, ep_mode="2d"))
    pshape = eval_shape(lambda: T.init(cfg, seed=0, device="cpu"))
    if kind != "train":
        pshape = _bf16(pshape)
    pspec = SH.lm_param_specs(pshape, mesh, moe_2d=(
        cfg.moe is not None and cfg.moe.ep_mode == "2d"))
    n_params = cfg.active_param_count()

    if kind == "train":
        def loss(p, batch):
            return T.loss_fn(p, batch["tokens"], batch["targets"], cfg,
                             mesh=mesh, data_axes=da)

        batch_spec = {"tokens": S((b, sl), torch.int32),
                      "targets": S((b, sl), torch.int32)}
        batch_sh = {"tokens": P(b_axes, None), "targets": P(b_axes, None)}
        ospec = SH.opt_specs(pspec, pshape, mesh)
        return Cell(
            spec.arch_id, shape_name, kind,
            _train_step(loss, mesh, pspec, ospec),
            (pshape, _adamw_shape(pshape), batch_spec),
            (pspec, ospec, batch_sh),
            (pspec, ospec, P()),
            model_flops=6.0 * n_params * b * sl,
            meta={"tokens": b * sl, "cfg": cfg},
        )

    if kind == "prefill":
        def prefill(p, batch):
            return T.prefill(p, batch["tokens"], cfg, mesh=mesh, data_axes=da)

        cache_sh = _kv_cache_spec(cfg, mesh, b, sl)[1]
        return Cell(
            spec.arch_id, shape_name, kind, _no_grad(prefill),
            (pshape, {"tokens": S((b, sl), torch.int32)}),
            (pspec, {"tokens": P(b_axes, None)}),
            (P(b_axes, "model"), cache_sh),
            model_flops=2.0 * n_params * b * sl,
            meta={"tokens": b * sl, "cfg": cfg},
        )

    # decode
    cache_shape, cache_sh = _kv_cache_spec(cfg, mesh, b, sl)

    def decode(p, cache, batch):
        return T.decode_step(p, cache, batch["token"], batch["position"], cfg,
                             mesh=mesh, data_axes=da)

    batch_spec = {"token": S((b,), torch.int32),
                  "position": S((b,), torch.int32)}
    batch_sh = {"token": P(b_axes), "position": P(b_axes)}
    return Cell(
        spec.arch_id, shape_name, kind, _no_grad(decode),
        (pshape, cache_shape, batch_spec),
        (pspec, cache_sh, batch_sh),
        (P(b_axes, "model"), cache_sh),
        model_flops=2.0 * n_params * b,   # + attention KV term reported in meta
        meta={"tokens": b, "kv_len": sl, "cfg": cfg},
    )


def _kv_cache_spec(cfg, mesh, b: int, sl: int):
    """The stacked (L, B, S, ...) cache's specs and placements: the batch
    over the data axes and the sequence over ``model`` where the batch
    splits, else the sequence over every axis (flash-decoding style)."""
    da = data_axes_of(mesh)
    if _div(b, axes_size(mesh, da)):
        b_ax, s_ax = da, "model"
    else:
        b_ax, s_ax = None, tuple(all_axes_of(mesh))
    dt = cfg.compute_dtype
    if cfg.attention == "mla":
        shape = {"c_kv": S((cfg.n_layers, b, sl, cfg.kv_lora_rank), dt),
                 "k_pe": S((cfg.n_layers, b, sl, cfg.qk_rope_dim), dt)}
        sh = {"c_kv": P(None, b_ax, s_ax, None),
              "k_pe": P(None, b_ax, s_ax, None)}
    else:
        kv = S((cfg.n_layers, b, sl, cfg.n_kv_heads, cfg.head_dim), dt)
        shape = {"k": kv, "v": kv}
        sh = {"k": P(None, b_ax, s_ax, None, None),
              "v": P(None, b_ax, s_ax, None, None)}
    return shape, sh


def _train_step(loss, mesh, pspec, ospec):
    """A zoo cell's AdamW step: the rank-local ``_sharded_train_step`` on a
    mesh of more than one rank, the plain one on one rank."""
    if mesh.size() == 1:
        return make_train_step(loss, AdamWConfig())
    return _sharded_train_step(loss, AdamWConfig(), mesh, pspec, ospec)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def build_gnn_cell(spec: ArchSpec, shape_name: str, mesh,
                   use_full: bool = True, cfg_override=None) -> Cell:
    base_cfg = cfg_override or (spec.full if use_full else spec.smoke)
    shp = spec.shapes[shape_name]
    n, e, d_feat = shp["n_nodes"], shp["n_edges"], shp["d_feat"]
    if not use_full:
        n, e, d_feat = min(n, 64), min(e, 256), min(d_feat, 8)
    cfg = dataclasses.replace(base_cfg, d_node_in=d_feat)
    # pad edges to a multiple of the device count for clean sharding
    ndev = mesh.size()
    e_pad = int(math.ceil(e / ndev) * ndev)
    axes = tuple(all_axes_of(mesh))
    pshape = eval_shape(lambda: G.init(cfg, seed=0, device="cpu"))
    pspec = SH.gnn_param_specs(pshape, mesh)

    def loss(p, batch):
        return G.loss_fn(p, batch["node_feats"], batch["edge_feats"],
                         batch["senders"], batch["receivers"],
                         batch["targets"], cfg, edge_mask=batch["edge_mask"],
                         mesh=mesh)

    f32 = torch.float32
    batch_spec = {
        "node_feats": S((n, d_feat), f32),
        "edge_feats": S((e_pad, cfg.d_edge_in), f32),
        "senders": S((e_pad,), torch.int32),
        "receivers": S((e_pad,), torch.int32),
        "edge_mask": S((e_pad,), torch.bool),
        "targets": S((n, cfg.d_out), f32),
    }
    batch_sh = {
        "node_feats": P(None, None),          # replicated (vertex-cut)
        "edge_feats": P(axes, None),
        "senders": P(axes),
        "receivers": P(axes),
        "edge_mask": P(axes),
        "targets": P(None, None),
    }
    # flops: per MP layer ~ edges * (3h->h MLP) + nodes * (2h->h MLP)
    h = cfg.d_hidden
    mp = cfg.n_layers * (e * (3 * h * h + h * h) + n * (2 * h * h + h * h)) * 2
    enc = (n * d_feat * h + e * cfg.d_edge_in * h + n * h * cfg.d_out) * 2
    ospec = SH.opt_specs(pspec, pshape, mesh)
    return Cell(
        spec.arch_id, shape_name, "train",
        _train_step(loss, mesh, pspec, ospec),
        (pshape, _adamw_shape(pshape), batch_spec),
        (pspec, ospec, batch_sh),
        (pspec, ospec, P()),
        model_flops=3.0 * (mp + enc),        # fwd + bwd ~ 3x fwd
        meta={"n_nodes": n, "n_edges": e, "cfg": cfg},
    )


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _recsys_batch(arch_id: str, cfg, b: int, mesh, with_label: bool):
    """(spec, shardings) for one batch of each recsys tenant's features."""
    b_axes, _ = _batch_axes(mesh, b)
    i32, f32, bool_ = torch.int32, torch.float32, torch.bool

    def bp(*rest):
        return P(b_axes, *rest)

    if arch_id == "two-tower-retrieval":
        spec = {
            "user_id": S((b,), i32),
            "uih_item_id": S((b, cfg.uih_len), i32),
            "uih_mask": S((b, cfg.uih_len), bool_),
            "cand_item_id": S((b,), i32),
        }
        sh = {
            "user_id": bp(), "uih_item_id": bp(None), "uih_mask": bp(None),
            "cand_item_id": bp(),
        }
        if with_label:
            spec["log_q"] = S((b,), f32)
            sh["log_q"] = bp()
    elif arch_id == "dcn-v2":
        spec = {
            "dense": S((b, cfg.n_dense), f32),
            "sparse_ids": S((b, cfg.n_sparse), i32),
        }
        sh = {"dense": bp(None), "sparse_ids": bp(None)}
    elif arch_id == "dien":
        spec = {
            "uih_item_id": S((b, cfg.seq_len), i32),
            "uih_category": S((b, cfg.seq_len), i32),
            "uih_mask": S((b, cfg.seq_len), bool_),
            "cand_item_id": S((b,), i32),
            "cand_category": S((b,), i32),
        }
        sh = {
            "uih_item_id": bp(None), "uih_category": bp(None),
            "uih_mask": bp(None), "cand_item_id": bp(), "cand_category": bp(),
        }
    elif arch_id == "bert4rec":
        spec = {
            "uih_item_id": S((b, cfg.seq_len), i32),
            "uih_mask": S((b, cfg.seq_len), bool_),
        }
        sh = {"uih_item_id": bp(None), "uih_mask": bp(None)}
        if with_label:
            spec["mask_pos"] = S((b, cfg.seq_len), bool_)
            sh["mask_pos"] = bp(None)
            spec["neg_ids"] = S((R.N_NEGATIVES,), i32)
            sh["neg_ids"] = P(None)
        else:
            spec["cand_item_id"] = S((b,), i32)
            sh["cand_item_id"] = bp()
    elif arch_id == "dlrm-uih":
        spec = {
            "uih_item_id": S((b, cfg.seq_len), i32),
            "uih_action_type": S((b, cfg.seq_len), i32),
            "uih_mask": S((b, cfg.seq_len), bool_),
            "cand_item_id": S((b,), i32),
            "sparse_ids": S((b, cfg.n_sparse), i32),
            "dense": S((b, cfg.n_dense), f32),
        }
        sh = {
            "uih_item_id": bp(None), "uih_action_type": bp(None),
            "uih_mask": bp(None), "cand_item_id": bp(),
            "sparse_ids": bp(None), "dense": bp(None),
        }
    else:
        raise KeyError(arch_id)
    if with_label and arch_id not in ("two-tower-retrieval", "bert4rec"):
        spec["label"] = S((b,), f32)
        sh["label"] = bp()
    return spec, sh


_RECSYS_FNS = {
    "two-tower-retrieval": (R.init_two_tower, R.two_tower_loss, None,
                            R.two_tower_score_candidates),
    "dcn-v2": (R.init_dcn_v2, R.dcn_v2_loss, R.dcn_v2_forward,
               R.dcn_v2_score_candidates),
    "dien": (R.init_dien, R.dien_loss, R.dien_forward, None),
    "bert4rec": (R.init_bert4rec, R.bert4rec_loss, R.bert4rec_forward,
                 R.bert4rec_score_candidates),
    "dlrm-uih": (R.init_dlrm_uih, R.dlrm_uih_loss, R.dlrm_uih_forward,
                 R.dlrm_uih_score_candidates),
}


def _two_tower_towers(cfg):
    d = cfg.embed_dim
    user = 2 * d * cfg.tower_mlp[0] + sum(
        cfg.tower_mlp[i] * cfg.tower_mlp[i + 1]
        for i in range(len(cfg.tower_mlp) - 1))
    item = d * cfg.tower_mlp[0] + sum(
        cfg.tower_mlp[i] * cfg.tower_mlp[i + 1]
        for i in range(len(cfg.tower_mlp) - 1))
    return user, item


def _recsys_flops(arch_id: str, cfg, b: int) -> float:
    """Per-step useful forward flops (dense-equivalent), x3 for training."""
    if arch_id == "two-tower-retrieval":
        d = cfg.embed_dim
        user, item = _two_tower_towers(cfg)
        return 2.0 * b * (user + item + cfg.uih_len * d) + 2.0 * b * b * d
    if arch_id == "dcn-v2":
        d = cfg.d_interact
        mlp = d * cfg.mlp[0] + sum(cfg.mlp[i] * cfg.mlp[i + 1]
                                   for i in range(len(cfg.mlp) - 1))
        return 2.0 * b * (cfg.n_cross_layers * d * d + mlp)
    if arch_id == "dien":
        per_step = 2 * (cfg.d_in * 3 * cfg.gru_dim + cfg.gru_dim * 3 * cfg.gru_dim)
        return 2.0 * b * cfg.seq_len * per_step
    if arch_id == "bert4rec":
        d = cfg.embed_dim
        per_tok = 12 * d * d + 2 * cfg.seq_len * d  # attn+ffn+scores
        return 2.0 * b * cfg.seq_len * cfg.n_blocks * per_tok
    if arch_id == "dlrm-uih":
        d = cfg.d_seq
        per_tok = 12 * d * d + 2 * cfg.seq_len * d
        return 2.0 * b * cfg.seq_len * cfg.n_seq_layers * per_tok
    raise KeyError(arch_id)


def build_recsys_cell(spec: ArchSpec, shape_name: str, mesh,
                      use_full: bool = True, cfg_override=None) -> Cell:
    cfg = cfg_override or (spec.full if use_full else spec.smoke)
    shp = spec.shapes[shape_name]
    b = shp["batch"]
    n_cand = shp.get("n_candidates", 0)
    if not use_full:
        b = max(2, min(b, 8))
        n_cand = min(n_cand, 64)
    init_fn, loss_fn, fwd_fn, score_fn = _RECSYS_FNS[spec.arch_id]
    kind = shp["kind"]
    axes = tuple(all_axes_of(mesh))
    ndev = mesh.size()
    # train/serve cells take the row-sharded embedding path; retrieval cells
    # shard their candidates over all axes (see the module docstring)
    if use_full and ndev > 1:
        cfg = dataclasses.replace(
            cfg, mesh=mesh, data_axes=(axes if kind == "retrieval"
                                       else data_axes_of(mesh)))
    pshape = eval_shape(lambda: init_fn(cfg, seed=0, device="cpu"))
    if kind != "train":
        pshape = _bf16(pshape)
    pspec = SH.recsys_param_specs(pshape, mesh)
    fwd_flops = _recsys_flops(spec.arch_id, cfg, b)

    if kind == "train":
        opt_cfg = AdamWConfig()
        oshape = _adamw_shape(pshape)
        ospec = SH.opt_specs(pspec, pshape, mesh)
        batch_spec, batch_sh = _recsys_batch(spec.arch_id, cfg, b, mesh, True)

        def loss(p, batch):
            return loss_fn(p, batch, cfg)

        step = (make_train_step(loss, opt_cfg) if cfg.mesh is None
                else _sharded_train_step(loss, opt_cfg, mesh, pspec, ospec))
        return Cell(
            spec.arch_id, shape_name, kind, step,
            (pshape, oshape, batch_spec),
            (pspec, ospec, batch_sh),
            (pspec, ospec, P()),
            model_flops=3.0 * fwd_flops,
            meta={"batch": b, "cfg": cfg},
        )

    if kind == "serve":
        batch_spec, batch_sh = _recsys_batch(spec.arch_id, cfg, b, mesh, False)
        b_axes, _ = _batch_axes(mesh, b)
        if spec.arch_id == "two-tower-retrieval":
            def fn(p, batch):
                return R.two_tower_user(p, batch["user_id"],
                                        batch["uih_item_id"],
                                        batch["uih_mask"], cfg)
            out_sh = P(b_axes, None)
            user, _ = _two_tower_towers(cfg)
            fwd_flops = 2.0 * b * (user + cfg.uih_len * cfg.embed_dim)
        else:
            def fn(p, batch):
                return fwd_fn(p, batch, cfg)
            out_sh = P(b_axes)
        return Cell(
            spec.arch_id, shape_name, kind, _no_grad(fn),
            (pshape, batch_spec), (pspec, batch_sh), out_sh,
            model_flops=fwd_flops,
            meta={"batch": b, "cfg": cfg},
        )

    # retrieval_cand
    batch_spec, batch_sh = _recsys_batch(spec.arch_id, cfg, 1, mesh, False)
    n_cand = int(math.ceil(n_cand / ndev) * ndev)   # pad to shard boundary
    cand_spec = S((n_cand,), torch.int32)
    cand_sh = P(axes)
    if spec.arch_id == "dien":
        def fn(p, batch, cand, cand_cat):
            return R.dien_score_candidates(p, batch, cand, cand_cat, cfg)
        args = (pshape, batch_spec, cand_spec, S((n_cand,), torch.int32))
        in_sh = (pspec, batch_sh, cand_sh, cand_sh)
    else:
        def fn(p, batch, cand):
            return score_fn(p, batch, cand, cfg)
        args = (pshape, batch_spec, cand_spec)
        in_sh = (pspec, batch_sh, cand_sh)
    return Cell(
        spec.arch_id, shape_name, kind, _no_grad(fn),
        args, in_sh, P(axes) if spec.arch_id in ("dcn-v2", "dien", "dlrm-uih")
        else P(None, axes),
        model_flops=_retrieval_flops(spec.arch_id, cfg, n_cand),
        meta={"n_candidates": n_cand, "cfg": cfg},
    )


def _retrieval_flops(arch_id: str, cfg, n: int) -> float:
    """Shared encoders run ONCE; only the per-candidate tail scales with N."""
    if arch_id == "two-tower-retrieval":
        user, item = _two_tower_towers(cfg)
        return 2.0 * (user + cfg.uih_len * cfg.embed_dim) \
            + 2.0 * n * (item + cfg.embed_dim)
    if arch_id == "dcn-v2":
        return _recsys_flops(arch_id, cfg, n)    # full forward per candidate
    if arch_id == "dien":
        h, s = cfg.gru_dim, cfg.seq_len
        gru1_once = 2.0 * s * (cfg.d_in * 3 * h + h * 3 * h)
        per_cand = 2.0 * s * (h * 3 * h + h * 3 * h) \
            + 2.0 * s * h + 2.0 * (h + 2 * cfg.d_in) * cfg.mlp[0]
        return gru1_once + n * per_cand
    if arch_id == "bert4rec":
        d = cfg.embed_dim
        enc_once = 2.0 * cfg.seq_len * cfg.n_blocks * (12 * d * d
                                                       + 4 * cfg.seq_len * d)
        return enc_once + 2.0 * n * d
    if arch_id == "dlrm-uih":
        d = cfg.d_seq
        enc_once = 2.0 * cfg.seq_len * cfg.n_seq_layers * (12 * d * d
                                                           + 4 * cfg.seq_len * d)
        f = 3 + cfg.n_sparse
        pairs = f * (f - 1) // 2
        per_cand = (2.0 * cfg.seq_len * d                 # target-aware pooling
                    + 2.0 * 3 * d * cfg.embed_dim         # projections
                    + 2.0 * f * f * cfg.embed_dim         # interactions
                    + 2.0 * ((pairs + cfg.embed_dim) * cfg.top_mlp[0]
                             + cfg.top_mlp[0] * cfg.top_mlp[1]))
        return enc_once + n * per_cand
    raise KeyError(arch_id)


# ---------------------------------------------------------------------------
# the train step on a mesh
# ---------------------------------------------------------------------------

def _zero_dim(pspec: P, mspec: P):
    """The dim (and its axes) that the moments shard over the data axes and
    the parameter does not (ZeRO), or ``(None, ())``."""
    for dim in range(len(mspec)):
        extra = tuple(a for a in mspec.dim_axes(dim)
                      if a not in pspec.dim_axes(dim))
        if extra:
            return dim, extra
    return None, ()


def _sharded_train_step(loss_fn, opt_cfg: AdamWConfig, mesh, pspec, ospec):
    """The rank-local AdamW step of a train cell on a mesh.

    ``loss_fn`` returns this rank's part of the global loss, so each
    gradient is a partial sum: it is summed over the mesh axes its
    parameter is replicated on, as a reduce-scatter over the data axes
    along the ZeRO dim where the moments are sharded there (then AdamW
    updates this rank's slice of the parameter, and an all-gather over the
    data axes restores the whole) and as an all-reduce over the rest. The
    global gradient norm sums each shard's squares once (divided by its
    replica count) in one all-reduce over the whole mesh."""
    everything = all_axes_of(mesh)
    p_specs = tree_leaves(pspec, is_leaf=SH.is_spec)
    m_specs = tree_leaves(ospec.m, is_leaf=SH.is_spec)
    table = LeafTable()

    def step(params, opt_state: AdamWState, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = tree_leaves(tree_grads(loss, params))
        views, shards, gathers = [], [], []
        sq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for i, (p, ps, ms) in enumerate(zip(leaves, p_specs, m_specs)):
            g, grads[i] = grads[i], None   # freed once its shard is taken
            rest = [a for a in everything if a not in ps.axes()]
            dim, z_axes = _zero_dim(ps, ms)
            view = p
            if dim is not None:
                g = funcol.reduce_scatter_tensor(
                    g, "sum", dim, axes_group(mesh, z_axes))
                rest = [a for a in rest if a not in z_axes]
                n = p.shape[dim] // axes_size(mesh, z_axes)
                view = p.narrow(dim, axes_rank(mesh, z_axes) * n, n)
                gathers.append((p, view, dim, z_axes))
            if rest:
                g = funcol.all_reduce(g, "sum", axes_group(mesh, rest))
            if dim is not None or rest:
                # AdamW's kernel reads the storage, which the collective's
                # wrapper tensor does not hold
                g = funcol.wait_tensor(g)
            replicas = axes_size(mesh, [a for a in everything
                                        if a not in ms.axes()])
            sq = sq + g.square().sum() / replicas
            views.append(view)
            shards.append(g)
        gnorm = torch.sqrt(funcol.all_reduce(sq, "sum",
                                             axes_group(mesh, everything)))
        it_p, it_g = iter(views), iter(shards)
        view_tree = tree_map(lambda _: next(it_p), params)
        grad_tree = tree_map(lambda _: next(it_g), params)
        _, opt_state, stats = adamw_update(view_tree, grad_tree, opt_state,
                                           opt_cfg, gnorm=gnorm, table=table)
        del grad_tree, shards          # the gathers below need their memory
        with torch.no_grad():
            for p, view, dim, z_axes in gathers:
                # gathered along dim 0 with ``dim`` moved first: no
                # chunk-and-concatenate copy of the whole parameter
                whole = funcol.all_gather_tensor(
                    view.movedim(dim, 0).contiguous(), 0,
                    axes_group(mesh, z_axes))
                p.copy_(whole.movedim(0, dim))
        total = funcol.all_reduce(loss.detach(), "sum",
                                  axes_group(mesh, everything))
        return params, opt_state, {"loss": total, **stats}

    return step


# ---------------------------------------------------------------------------
# Device feed: host data plane -> placed device batches
#
# DEPRECATED SHIMS. The declarative read path (repro_torch.data) replaced
# both: describe the feed as a DatasetSpec and call
# ``repro_torch.data.open_feed(spec, sim, cell=cell, mesh=mesh, ...)``. They
# keep the reference's call sites working over the port's ``open_feed``.
# ---------------------------------------------------------------------------

def make_device_feed(cell: Cell, spec, sim, mesh=None, device: Any = "cuda"):
    """DEPRECATED: use ``repro_torch.data.open_feed`` (a thin shim).

    ``spec`` (a ``DatasetSpec``) over ``sim``, its device batches placed
    with ``cell``'s batch placements on ``mesh``."""
    import warnings

    from repro_torch.data import open_feed

    warnings.warn(
        "launch.steps.make_device_feed is deprecated; build a "
        "repro_torch.data.DatasetSpec and call repro_torch.data.open_feed "
        "instead", DeprecationWarning, stacklevel=2)
    return open_feed(spec, sim, device=device, cell=cell, mesh=mesh)


def make_streaming_feed(cell: Cell, spec, sim, mesh=None,
                        device: Any = "cuda"):
    """DEPRECATED: use ``repro_torch.data.open_feed`` with a
    ``StreamSource`` spec (a thin shim over it)."""
    import warnings

    from repro_torch.data import StreamSource, open_feed

    if not isinstance(spec.source, StreamSource):
        raise ValueError("make_streaming_feed needs a StreamSource spec")
    warnings.warn(
        "launch.steps.make_streaming_feed is deprecated; build a "
        "repro_torch.data.DatasetSpec(source=StreamSource(...)) and call "
        "repro_torch.data.open_feed instead", DeprecationWarning,
        stacklevel=2)
    return open_feed(spec, sim, device=device, cell=cell, mesh=mesh)


def build_cell(spec: ArchSpec, shape_name: str, mesh, use_full=True,
               cfg_override=None) -> Cell:
    if spec.family == "lm":
        return build_lm_cell(spec, shape_name, mesh, use_full, cfg_override)
    if spec.family == "gnn":
        return build_gnn_cell(spec, shape_name, mesh, use_full, cfg_override)
    if spec.family == "recsys":
        return build_recsys_cell(spec, shape_name, mesh, use_full, cfg_override)
    raise KeyError(spec.family)
