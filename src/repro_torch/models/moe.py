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
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import parallel as PL
from repro_torch.models.layers import _init

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    router_dtype: torch.dtype = torch.float32
    # expert-parallel weight layout on a mesh (the reference's):
    #   "fsdp": E on model, d_ff ZeRO-sharded on data (training)
    #   "2d":   E on model AND d/f dims on data, fully resident (decode)
    ep_mode: str = "fsdp"


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             device="cuda", dtype: torch.dtype = torch.float32) -> Params:
    e, f = cfg.n_experts, cfg.d_ff

    def w(shape, scale=None):
        return _init(gen, shape, scale, device=device, dtype=dtype)

    p = {
        "router": w((d_model, e), 0.02),
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
    """(gate, idx), each (T, k): the renormalized top-k router
    probabilities and their experts, best first (``torch.topk`` sorted, as
    ``jax.lax.top_k``)."""
    rd = cfg.router_dtype
    probs = torch.softmax(x.to(rd) @ router_w.to(rd), dim=-1)   # (T, E)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    return gate / gate.sum(dim=-1, keepdim=True), idx


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
