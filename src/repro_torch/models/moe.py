"""Mixture-of-Experts FFN (top-k routed + optional shared experts).

Port of ``repro.models.moe``. Each token's top-k experts come from a
float32 router; tokens reach their experts by an index-based dispatch
(sort by expert, rank within the expert, no (T, E, C) one-hot tensor),
the experts run as one grouped product over (E, C, d), and the weighted
outputs are scatter-added back to their tokens.

The reference runs the dispatch inside ``shard_map`` bodies, one model
rank a block of experts (``_moe_inner``, EP + FSDP) or a block of experts
and of the contraction dims (``_moe_inner_2d``, the decode layout). Here
both bodies are rank-local functions of the rank's indices. With
``mesh=None`` the whole program runs with every expert local; on a
one-rank mesh each body runs as rank 0 with axis sizes of 1, where its
collectives are identities. On a larger mesh (``_moe_local``):

  * FSDP (train, prefill): the layer's ``w_in``/``w_out`` blocks are
    all-gathered over ``data`` (the adjoint, in the backward, is a
    reduce-scatter), each rank routes its data block of tokens (the
    capacity comes from that local count, as the reference's ``t_loc``)
    through its ``model`` rank's experts, and the outputs are summed over
    ``model``.
  * ``2d`` (decode): the tokens are gathered over ``data_axes`` (the axes
    the batch is split on, none for a batch of 1), each rank multiplies its block of experts and of the
    contraction dims (the reference's data axis is ``("data",)``, even on
    two pods), the partial products are summed over ``data`` and the
    output over ``model`` and ``data``; each rank keeps its batch rows.
  * Shared experts are column-parallel in, row-parallel out: the fused
    gate/up columns are gathered over ``model`` (the two halves of a
    rank's rows of ``shared_w_out`` lie on different ranks), and the
    output is summed over ``model``.

Dropless routing and an expert share (``capacity_factor=None``,
``moe_dropless``). The layer is told which experts it holds
(``n_held`` of them from ``first_held``: one card's share of an
expert-parallel deployment, with no exchange on one card), routes every
token over all ``n_experts`` and computes the held experts' pairs only,
every one of them: the pairs are sorted by expert, the per-expert offsets
stay on the card, and the experts run as one grouped product over rows of
varying length (``kernels.grouped_gemm``), so the layer never syncs with
the host. A token's pairs are summed in a fixed order with float32 sums,
in the combine and in the token gather's backward, so two passes give the
same bits. What the absent experts would add is left out. The gate is the
softmax score itself where ``norm_topk_prob`` is False (DeepSeek's
``greedy`` gating, scale 1), and ``aux_alpha`` adds the sequence-level
balance loss over the sequences' valid positions. ``STATS`` counts the
layer's work on the card and files ``moe.route`` and ``moe.experts``
spans when a ``Telemetry`` is attached.

Dropped pairs. A (token, expert) pair whose rank in its expert is
``>= cap`` is dropped, and only such pairs. The reference routes every
dropped pair to the real slot ``(0, cap - 1)`` with a ``.at[].set`` that
lets the later write win, so when expert 0 fills and any pair overflows,
the token in expert 0's last slot loses its expert-0 output (a fault of
the reference, kept there). Here dropped pairs go to a scratch slot past
the table, sliced off before the experts run.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_gemm import grouped_mm
from repro_torch.models import parallel as PL
from repro_torch.models.layers import _init
from repro_torch.obs.spans import PhaseClock

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # the router's width
    top_k: int
    d_ff: int                      # per-expert hidden
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: Optional[float] = 1.25   # None: dropless
    router_dtype: torch.dtype = torch.float32
    # expert-parallel weight layout on a mesh (the reference's):
    #   "fsdp": E on model, d_ff ZeRO-sharded on data (training)
    #   "2d":   E on model AND d/f dims on data, fully resident (decode)
    ep_mode: str = "fsdp"
    # the experts this layer holds (dropless only): n_held from first_held
    n_held: Optional[int] = None   # None: all n_experts
    first_held: int = 0
    norm_topk_prob: bool = True    # renormalize the top-k gates to sum 1
    aux_alpha: float = 0.0         # sequence-level balance loss weight

    @property
    def held(self) -> int:
        return self.n_experts if self.n_held is None else self.n_held


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             device="cuda", dtype: torch.dtype = torch.float32) -> Params:
    e, f = cfg.held, cfg.d_ff

    def w(shape, scale=None):
        return _init(gen, shape, scale, device=device, dtype=dtype)

    p = {
        "router": w((d_model, cfg.n_experts), 0.02),
        # fused gate+up per expert: (E, d, 2f); down: (E, f, d)
        "w_in": w((e, d_model, 2 * f)),
        "w_out": w((e, f, d_model), 1.0 / math.sqrt(f)),
    }
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p["shared_w_in"] = w((d_model, 2 * fs))
        p["shared_w_out"] = w((fs, d_model), 1.0 / math.sqrt(fs))
    return p


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(math.ceil(cfg.top_k * n_tokens / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, int(math.ceil(c / 8)) * 8)  # pad to sublane multiple


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gate, idx), each (T, k): the top-k router probabilities
    (renormalized with ``norm_topk_prob``) and their experts, best first
    (``torch.topk`` sorted, as ``jax.lax.top_k``)."""
    return _top_k(_scores(x, router_w, cfg), cfg)


def _scores(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig
            ) -> torch.Tensor:
    """(T, E) router probabilities in ``router_dtype``."""
    rd = cfg.router_dtype
    return torch.softmax(x.to(rd) @ router_w.to(rd), dim=-1)


def _top_k(probs: torch.Tensor, cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    if cfg.norm_topk_prob:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    return gate, idx


def dispatch(idx: torch.Tensor, gate: torch.Tensor, cfg: MoEConfig, cap: int,
             e_loc: int, offset: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch tables of experts ``[offset, offset + e_loc)``: (E_loc,
    cap) source token ids (``T`` = the zero row) and combine weights.

    Pairs are grouped by expert in token order (a stable sort); a pair's
    rank in its expert is its position after the expert's start
    (``searchsorted``, left side). A pair is kept when its expert is local
    and its rank is below ``cap``; every other pair writes the scratch
    slot ``e_loc * cap``, which is sliced off."""
    t, k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)                # group by expert
    se, st, sg = flat_e[order], flat_t[order], gate.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(cfg.n_experts, device=dev,
                                                 dtype=se.dtype))
    pos = torch.arange(t * k, device=dev) - starts[se]        # rank in expert
    local_e = se - offset
    keep = (local_e >= 0) & (local_e < e_loc) & (pos < cap)
    slot = torch.where(keep, local_e * cap + pos, e_loc * cap)
    disp_t = torch.full((e_loc * cap + 1,), t, dtype=torch.long, device=dev)
    disp_t = disp_t.index_put((slot,), torch.where(keep, st, t))
    disp_g = torch.zeros((e_loc * cap + 1,), dtype=sg.dtype, device=dev)
    disp_g = disp_g.index_put((slot,), torch.where(keep, sg, 0.0))
    return (disp_t[:-1].reshape(e_loc, cap),
            disp_g[:-1].reshape(e_loc, cap))


def _combine(oe: torch.Tensor, disp_t: torch.Tensor, disp_g: torch.Tensor,
             t: int) -> torch.Tensor:
    """Weighted scatter-add of expert outputs (E_loc, cap, d) back to their
    ``t`` tokens (the zero row ``t`` takes empty slots and is dropped)."""
    d = oe.shape[-1]
    oe = oe * disp_g[..., None].to(oe.dtype)
    out = torch.zeros((t + 1, d), dtype=oe.dtype, device=oe.device)
    return out.index_add(0, disp_t.reshape(-1), oe.reshape(-1, d))[:t]


def _swiglu_halves(h: torch.Tensor) -> torch.Tensor:
    g, u = torch.chunk(h, 2, dim=-1)
    return F.silu(g) * u


def _moe_inner(
    x: torch.Tensor,          # (T, d) this rank's token block
    router_w: torch.Tensor,   # (d, E)
    w_in: torch.Tensor,       # (E_loc, d, 2f) this rank's experts
    w_out: torch.Tensor,      # (E_loc, f, d)
    cfg: MoEConfig,
    model_rank: int = 0,
) -> torch.Tensor:
    """The EP (+FSDP) body: this model rank's experts over its tokens. The
    reference's psum over ``model`` is the identity on one rank."""
    t, d = x.shape
    e_loc = w_in.shape[0]
    dt = x.dtype
    cap = _capacity(t, cfg)
    gate, idx = route(x, router_w, cfg)
    disp_t, disp_g = dispatch(idx, gate, cfg, cap, e_loc, model_rank * e_loc)
    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    xe = x_pad[disp_t]                                        # (E_loc, cap, d)
    h = _swiglu_halves(torch.bmm(xe, w_in.to(dt)))            # (E_loc, cap, f)
    oe = torch.bmm(h, w_out.to(dt))                           # (E_loc, cap, d)
    return _combine(oe, disp_t, disp_g, t)


def _moe_inner_2d(
    x: torch.Tensor,          # (T, d) the FULL token block
    router_w: torch.Tensor,   # (d, E)
    w_in: torch.Tensor,       # (E_loc, d_loc, 2f): E on model, d on data
    w_out: torch.Tensor,      # (E_loc, f_loc, d): E on model, f on data
    cfg: MoEConfig,
    model_rank: int = 0,
    data_rank: int = 0,
    mesh=None,
    data_axis: Tuple[str, ...] = (),
) -> torch.Tensor:
    """The fully-resident 2D body (decode): this rank's block of experts
    and of the contraction dims. The partial products are summed over
    ``data_axis`` of ``mesh`` (the identity on one rank); the caller sums
    the output over every axis."""
    t, d = x.shape
    e_loc, d_loc, _ = w_in.shape
    dt = x.dtype
    cap = _capacity(t, cfg)
    gate, idx = route(x, router_w, cfg)
    disp_t, disp_g = dispatch(idx, gate, cfg, cap, e_loc, model_rank * e_loc)
    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    xe = x_pad[disp_t].narrow(2, data_rank * d_loc, d_loc)   # (E_loc, cap, d_loc)
    h = torch.bmm(xe, w_in.to(dt))                            # (E_loc, cap, 2f)
    if PL.tp(mesh):
        h = PL.sum_over(h, mesh, data_axis)
    h = _swiglu_halves(h)
    f_loc = w_out.shape[1]
    h = h.narrow(2, data_rank * f_loc, f_loc)
    oe = torch.bmm(h, w_out.to(dt))
    return _combine(oe, disp_t, disp_g, t)


def _moe_local(params: Params, xt: torch.Tensor, cfg: MoEConfig, mesh,
               data_axes: Tuple[str, ...], model_axis: str) -> torch.Tensor:
    """The routed experts' rank-local program on a mesh (module
    docstring): ``xt`` is this rank's block of tokens over
    ``data_axes``."""
    m_ax = (model_axis,)
    mr = PL.rank_of(mesh, m_ax)
    if cfg.ep_mode == "2d":
        wd = ("data",)
        every = PL.gather_over(xt, 0, mesh, data_axes)
        out = _moe_inner_2d(every, params["router"], params["w_in"],
                            params["w_out"], cfg, mr, PL.rank_of(mesh, wd),
                            mesh, wd)
        return PL.block(PL.sum_over(out, mesh, m_ax + wd), 0, mesh,
                        data_axes)
    w_in = PL.gather_over(params["w_in"], -1, mesh, ("data",))
    w_out = PL.gather_over(params["w_out"], -1, mesh, ("data",))
    out = _moe_inner(xt, params["router"], w_in, w_out, cfg, mr)
    return PL.sum_over(out, mesh, m_ax)


def moe_ffn(
    params: Params,
    x: torch.Tensor,               # (B, S, d) or (T, d)
    cfg: MoEConfig,
    mesh: Optional[Any] = None,
    data_axes: Tuple[str, ...] = ("data",),
    model_axis: str = "model",
) -> torch.Tensor:
    """On a mesh ``x`` holds this rank's block of tokens over ``data_axes``
    (the reference's ``shard_map`` token split)."""
    if cfg.capacity_factor is None or cfg.n_held is not None:
        raise ValueError("moe_ffn routes with a capacity over every expert; "
                         "a dropless layer or an expert share is "
                         "moe_dropless")
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    args = (xt, params["router"], params["w_in"], params["w_out"], cfg)
    if PL.tp(mesh):
        dt = x.dtype
        m_ax = (model_axis,)
        out = _moe_local(params, xt, cfg, mesh, tuple(data_axes or ()),
                         model_axis)
        if "shared_w_in" in params:
            hs = PL.gather_over(xt @ params["shared_w_in"].to(dt), -1, mesh,
                                m_ax)
            hs = PL.block(_swiglu_halves(hs), -1, mesh, m_ax)
            out = out + PL.sum_over(hs @ params["shared_w_out"].to(dt), mesh,
                                    m_ax)
        return out.reshape(shape)
    if mesh is not None and cfg.ep_mode == "2d":
        out = _moe_inner_2d(*args)
    else:
        out = _moe_inner(*args)
    if "shared_w_in" in params:
        dt = x.dtype
        h = _swiglu_halves(xt @ params["shared_w_in"].to(dt))
        out = out + h @ params["shared_w_out"].to(dt)
    return out.reshape(shape)


class MoEStats:
    """The dropless layer's counters and spans.

    Counted at every pass of the layer (a recomputation under remat
    included): ``tokens`` (a plain integer), and on the card, so that
    counting takes no sync, the pairs computed here (``pairs_held``), the
    largest number of them one expert got in one pass
    (``max_expert_load``) and the held experts' pairs left out
    (``dropped``: the held pairs of the router's top-k, counted from its
    indices, less the rows the grouped product ran, which the sort's row
    bound ``_held_rows`` caps; 0 while that bound holds). ``read()``
    returns all four as integers (it reads the card: call it after the
    steps). With ``telemetry`` set, each
    pass files the phases ``moe.route`` and ``moe.experts`` in its span
    tracker, with the CUDA-event device ms of each on the card."""

    def __init__(self):
        self.telemetry = None
        self.reset()

    def reset(self) -> None:
        self.tokens = 0
        self._dev: Dict[torch.device, torch.Tensor] = {}
        self._clocks = threading.local()

    def add(self, tokens: int, counts: torch.Tensor) -> None:
        """``counts``: int64 (pairs computed, largest expert load, held
        pairs left out) of one pass."""
        self.tokens += tokens
        acc = self._dev.get(counts.device)
        if acc is None:
            self._dev[counts.device] = counts.clone()
            return
        acc[1] = torch.maximum(acc[1], counts[1])
        acc[0::2] += counts[0::2]

    def read(self) -> Dict[str, int]:
        out = {"tokens": self.tokens, "pairs_held": 0, "max_expert_load": 0,
               "dropped": 0}
        for acc in self._dev.values():
            pairs, load, dropped = acc.tolist()
            out["pairs_held"] += pairs
            out["max_expert_load"] = max(out["max_expert_load"], load)
            out["dropped"] += dropped
        return out

    def clock(self, device: torch.device) -> Optional[PhaseClock]:
        """The calling thread's phase clock (None without telemetry)."""
        tel = self.telemetry
        if tel is None:
            return None
        clock = getattr(self._clocks, "clock", None)
        if clock is None or clock.tracker is not tel.spans:
            event = (functools.partial(torch.cuda.Event, enable_timing=True)
                     if device.type == "cuda" else None)
            clock = self._clocks.clock = PhaseClock(tel.spans, event)
        return clock


STATS = MoEStats()


def balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                 valid: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """DeepSeek's sequence-level balance loss ``alpha * mean_b sum_i
    f_bi P_bi`` over the valid positions t of each sequence b (n_b of
    them): ``f_bi = E / (K n_b) * #{(t, k): idx_tk = i}`` and ``P_bi =
    mean_t probs_ti``. ``probs`` (B, S, E), ``idx`` (B, S, K), ``valid``
    (B, S) bool. A sequence with no valid position adds 0."""
    e, k = cfg.n_experts, cfg.top_k
    w = valid.to(probs.dtype)
    n = w.sum(1).clamp(min=1.0)[:, None]                         # (B, 1)
    experts = torch.arange(e, device=idx.device)
    hits = (idx[..., None] == experts).sum(2).to(probs.dtype)    # (B, S, E)
    f = (hits * w[..., None]).sum(1) * (e / k) / n
    p = (probs * w[..., None]).sum(1) / n
    return cfg.aux_alpha * (f * p).sum(-1).mean()


class _PairGather(torch.autograd.Function):
    """``x``'s rows for the pairs ``order`` (indices into the ``T * k``
    pairs of the router's top-k; a pair's token is ``pair // k``). The
    backward puts each pair's gradient in its own slot of a ``(T, k)``
    table and sums over ``k`` with float32 sums, rounding once, in a fixed
    order: ``index_select``'s own backward adds a token's pairs into
    ``x``'s dtype with atomics, one rounding a pair, in no fixed order."""

    @staticmethod
    def forward(ctx, x, order, k: int):
        ctx.save_for_backward(order)
        ctx.k = k
        ctx.t = x.shape[0]
        return x.index_select(0, order // k)

    @staticmethod
    def backward(ctx, dy):
        (order,) = ctx.saved_tensors
        slots = dy.new_zeros((ctx.t * ctx.k, dy.shape[-1]))
        slots.index_copy_(0, order, dy)
        return slots.view(ctx.t, ctx.k, -1).sum(1), None, None


def _combine_pairs(y: torch.Tensor, g: torch.Tensor, order: torch.Tensor,
                   t: int, k: int) -> torch.Tensor:
    """(T, d) float32: each token's gated pair outputs ``y * g`` summed in a
    fixed order (each pair in its own slot of a ``(T, k)`` table, then a sum
    over ``k``), where ``index_add`` would add them with atomics."""
    slots = torch.zeros((t * k, y.shape[-1]), dtype=torch.float32,
                        device=y.device)
    slots = slots.index_copy(0, order, y.float() * g[:, None])
    return slots.view(t, k, -1).sum(1)


def _held_rows(tokens: int, cfg: MoEConfig) -> int:
    """Rows of the grouped product's operands: a token picks at most
    ``min(top_k, held)`` held experts, so every held pair lies in the first
    this many of the pairs sorted by expert (the bound that dropless with
    no host sync needs)."""
    return tokens * min(cfg.top_k, cfg.held)


def moe_dropless(params: Params, x: torch.Tensor, cfg: MoEConfig,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(output, balance loss or None) of the dropless layer over ``x`` (B,
    S, d) or (T, d): every token routed over all ``n_experts``; the held
    experts' pairs, all of them, through ``grouped_mm``; the shared experts
    added. ``mask`` (B, S): the positions the balance loss counts (default
    all). No host sync."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t, dt = xt.shape[0], x.dtype
    held, k = cfg.held, cfg.top_k
    clock = STATS.clock(xt.device)
    if clock is not None:
        clock.start()
        clock.mark()
    probs = _scores(xt, params["router"], cfg)                  # (T, E)
    gate, idx = _top_k(probs, cfg)
    local = (idx - cfg.first_held).reshape(-1)                  # (T k,)
    mine = (local >= 0) & (local < held)
    key = torch.where(mine, local, held)            # other experts sort last
    rows = _held_rows(t, cfg)
    order = torch.argsort(key, stable=True)[:rows]
    sk = key[order]
    offsets = torch.searchsorted(sk, torch.arange(held + 1, device=sk.device,
                                                  dtype=sk.dtype))
    g = torch.where(sk < held, gate.reshape(-1).index_select(0, order), 0.0)
    aux = None
    if cfg.aux_alpha:
        b = shape[0] if len(shape) == 3 else 1
        valid = (torch.ones((b, t // b), dtype=torch.bool, device=x.device)
                 if mask is None else mask.reshape(b, t // b))
        aux = balance_loss(probs.reshape(b, t // b, -1),
                           idx.reshape(b, t // b, k), valid, cfg)
    loads = offsets[1:] - offsets[:-1]
    STATS.add(t, torch.stack([offsets[-1], loads.max(),
                              mine.sum() - offsets[-1]]))
    if clock is not None:
        clock.mark("route")
        clock.lap("moe.route")
    h = _swiglu_halves(grouped_mm(_PairGather.apply(xt, order, k),
                                  params["w_in"].to(dt), offsets))
    y = grouped_mm(h, params["w_out"].to(dt), offsets)         # (rows, d)
    out = _combine_pairs(y, g, order, t, k).to(dt)
    if "shared_w_in" in params:
        hs = _swiglu_halves(xt @ params["shared_w_in"].to(dt))
        out = out + hs @ params["shared_w_out"].to(dt)
    if clock is not None:
        clock.mark("experts")
        clock.lap("moe.experts")
        clock.commit()
    return out.reshape(shape), aux


def moe_ref(params: Params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Dense per-token oracle (no capacity drops) for tests: every token is
    processed by its exact top-k experts via a full product over E."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    dt = x.dtype
    gate, idx = route(xt, params["router"],
                      dataclasses.replace(cfg, router_dtype=torch.float32))
    h = _swiglu_halves(torch.einsum("td,edf->tef", xt,
                                    params["w_in"].to(dt)))
    o = torch.einsum("tef,efd->ted", h, params["w_out"].to(dt))
    mask = F.one_hot(idx, cfg.n_experts).float()              # (T, k, E)
    w = torch.einsum("tk,tke->te", gate, mask).to(dt)
    out = torch.einsum("te,ted->td", w, o)
    if "shared_w_in" in params:
        hs = _swiglu_halves(xt @ params["shared_w_in"].to(dt))
        out = out + hs @ params["shared_w_out"].to(dt)
    return out.reshape(shape)
