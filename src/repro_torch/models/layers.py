"""Shared layers in plain PyTorch: RMSNorm, RoPE, GQA attention chunked over
queries, SwiGLU MLP.

Port of the parts of ``repro.models.layers`` the DLRM-UIH encoder uses.
Parameters are dicts of tensors in the reference's layout (``wq`` is
(d_model, H*Dh) and multiplies from the right). Attention is plain
``torch.matmul``/``softmax``, chunked by ``q_chunk`` as the reference does
(scores never live at (S, S)); it keeps the reference's finite ``-1e30``
mask value, so a query position whose every key is masked (right-aligned
rows) stays finite instead of turning NaN.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]
MASK_VALUE = -1e30


def _init(gen: torch.Generator, shape, scale=None, device="cuda"):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, device=device).mul_(scale)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 1e6, device=None
                     ) -> torch.Tensor:
    exponent = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim)
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6
               ) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (int)."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)           # (dh/2,)
    ang = positions[..., None].float() * freqs              # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention, chunked over queries
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 1e6
    q_chunk: int = 1024   # queries per chunk: scores live at (B,H,q_chunk,S)


def init_gqa(gen: torch.Generator, cfg: AttnConfig, device="cuda") -> Params:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": _init(gen, (d, h * dh), device=device),
        "wk": _init(gen, (d, hk * dh), device=device),
        "wv": _init(gen, (d, hk * dh), device=device),
        "wo": _init(gen, (h * dh, d), device=device),
    }


def _attend_chunked(
    q: torch.Tensor,            # (B, Sq, H, Dh)
    k: torch.Tensor,            # (B, Sk, Hk, Dh)  Hk divides H
    v: torch.Tensor,            # (B, Sk, Hk, Dv)
    q_positions: torch.Tensor,  # (B, Sq)
    kv_positions: torch.Tensor, # (B, Sk)
    kv_mask: Optional[torch.Tensor],  # (B, Sk) valid mask or None
    causal: bool,
    q_chunk: int,
) -> torch.Tensor:
    """Scores and softmax in float32 (the reference's ``scores_f32``), the
    value product in the compute dtype."""
    b, sq, h, dh = q.shape
    hk = k.shape[2]
    dv = v.shape[3]
    rep = h // hk
    scale = 1.0 / math.sqrt(dh)
    qc = min(q_chunk, sq)
    k32 = k.float()
    outs = []
    for lo in range(0, sq, qc):
        qi = q[:, lo:lo + qc].reshape(b, -1, hk, rep, dh)   # (B, qc, Hk, rep, Dh)
        qpi = q_positions[:, lo:lo + qc]
        s = torch.einsum("bqhrd,bkhd->bhrqk", qi.float(), k32) * scale
        if causal:
            cm = (qpi[:, None, None, :, None]
                  >= kv_positions[:, None, None, None, :])
            s = torch.where(cm, s, MASK_VALUE)
        if kv_mask is not None:
            s = torch.where(kv_mask[:, None, None, None, :], s, MASK_VALUE)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhrqk,bkhd->bqhrd", p, v))
    return torch.cat(outs, dim=1).reshape(b, sq, h, dv)


def _qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
         cfg: AttnConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(b, s, h, dh)
    k = (x @ params["wk"].to(dt)).reshape(b, s, hk, dh)
    v = (x @ params["wv"].to(dt)).reshape(b, s, hk, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(
    params: Params,
    x: torch.Tensor,                    # (B, S, D)
    positions: torch.Tensor,            # (B, S)
    cfg: AttnConfig,
    causal: bool = True,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention over x (training / prefill)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, positions, cfg)
    out = _attend_chunked(q, k, v, positions, positions, kv_mask, causal,
                          cfg.q_chunk)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                device="cuda") -> Params:
    return {
        "w_gate": _init(gen, (d_model, d_ff), device=device),
        "w_up": _init(gen, (d_model, d_ff), device=device),
        "w_down": _init(gen, (d_ff, d_model), device=device),
    }


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = F.silu(x @ params["w_gate"].to(dt))
    u = x @ params["w_up"].to(dt)
    return (g * u) @ params["w_down"].to(dt)
