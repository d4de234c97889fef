"""Shared layers in plain PyTorch: RMSNorm, RoPE, qk-norm, GQA and MLA
attention chunked over queries, SwiGLU MLP.

Port of ``repro.models.layers``. Parameters are dicts of tensors in the
reference's layout (``wq`` is (d_model, H*Dh) and multiplies from the
right). Attention is plain ``torch.matmul``/``softmax``, chunked by
``q_chunk`` as the reference does (scores never live at (S, S)); it keeps
the reference's finite ``-1e30`` mask value, so a query position whose
every key is masked (right-aligned rows) stays finite instead of turning
NaN.

The decode paths write the new token's cache entry in place (the caller's
cache tensors are updated, and returned): at 32k positions a functional
update would copy every layer's cache each step. Where the reference's
``dynamic_update_slice`` clamps an out-of-range start into the cache, so
does ``_write_at``.

Given a mesh of more than one rank (``parallel.tp``), each function is the
rank-local program of the reference's Megatron placement
(``launch.shardings.lm_param_specs``): q/k/v, gate/up and MLA's
``w_uk``/``w_uv`` hold this rank's column block, ``wo``/``w_down`` its row
block, and the output is summed over ``model``. Where a rank's k/v columns
are part of a KV head (more ``model`` ranks than KV heads), it gathers its
head's columns from the ranks that share it before attending. Decode
attends over this rank's block of the cache's positions for every head and
merges the partials by a log-sum-exp combine over the cache's sequence
axes; the new entry is written by the rank that owns its position.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import parallel as PL
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]
MASK_VALUE = -1e30


_DRAW_BLOCK = 1 << 28   # float32 elements drawn at once for a narrow dtype


def generator(device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (the
    ``meta`` device draws nothing: a CPU generator stands in)."""
    dev = torch.device(device)
    return torch.Generator(device="cpu" if dev.type == "meta" else dev
                           ).manual_seed(seed)


def _init(gen: torch.Generator, shape, scale=None, device="cuda",
          dtype: torch.dtype = torch.float32):
    """Standard normal times ``scale`` (default ``1/sqrt(shape[0])``). A
    dtype other than float32 is drawn in float32 a block of rows of axis 0
    at a time (at most ``_DRAW_BLOCK`` elements) and cast block by block,
    so the float32 peak is one block, never the leaf: a FULL MoE layer
    stack's ``w_in`` is 77 GB in float32."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    if dtype == torch.float32:
        return torch.randn(shape, generator=gen, device=device).mul_(scale)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, _DRAW_BLOCK // max(1, math.prod(shape[1:])))
    for lo in range(0, shape[0], rows):
        n = min(rows, shape[0] - lo)
        out[lo:lo + n] = torch.randn((n, *shape[1:]), generator=gen,
                                     device=device).mul_(scale)
    return out


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

@dataclasses.dataclass(frozen=True)
class YaRN:
    """YaRN's stretch of RoPE (a config's ``rope_scaling`` of type
    ``yarn``), as DeepSeek-V2's published modelling code applies it."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    def correction_range(self, dim: int, theta: float) -> Tuple[int, int]:
        """(low, high): the frequency indices between which the ramp runs
        from the original frequencies to the stretched ones."""
        def at(rotations):
            return dim * math.log(self.original_max_position / (
                rotations * 2 * math.pi)) / (2 * math.log(theta))

        return (max(math.floor(at(self.beta_fast)), 0),
                min(math.ceil(at(self.beta_slow)), dim - 1))

    @staticmethod
    def _mscale(factor: float, mscale: float) -> float:
        return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0

    def attention_scale(self) -> float:
        """What the softmax scale is multiplied by: ``mscale(all_dim)^2``
        (1 without ``mscale_all_dim``)."""
        if not self.mscale_all_dim:
            return 1.0
        return self._mscale(self.factor, self.mscale_all_dim) ** 2

    def cos_sin_scale(self) -> float:
        return (self._mscale(self.factor, self.mscale)
                / self._mscale(self.factor, self.mscale_all_dim))


def rope_frequencies(head_dim: int, theta: float = 1e6, device=None,
                     yarn: Optional[YaRN] = None) -> torch.Tensor:
    exponent = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim)
    freqs = 1.0 / (theta ** exponent)
    if yarn is None:
        return freqs
    low, high = yarn.correction_range(head_dim, theta)
    ramp = (torch.arange(head_dim // 2, dtype=torch.float32, device=device)
            - low) / max(high - low, 1e-3)
    keep = 1.0 - ramp.clamp(0.0, 1.0)      # 1: the original frequency
    return freqs / yarn.factor * (1.0 - keep) + freqs * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6,
               yarn: Optional[YaRN] = None) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (int). The rotation pairs
    the two halves of Dh (DeepSeek's published code pairs interleaved
    dimensions: the same rotation after a fixed permutation of them)."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device, yarn)     # (dh/2,)
    ang = positions[..., None].float() * freqs              # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    if yarn is not None and yarn.cos_sin_scale() != 1.0:
        cos, sin = cos * yarn.cos_sin_scale(), sin * yarn.cos_sin_scale()
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (optionally qk-normed), chunked over queries
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 1e6
    q_chunk: int = 1024   # queries per chunk: scores live at (B,H,q_chunk,S)
    scores_f32: bool = True  # False: keep the score pipeline in compute dtype
                             # (halves attention traffic; recsys encoders)


def init_gqa(gen: torch.Generator, cfg: AttnConfig, device="cuda",
             dtype: torch.dtype = torch.float32) -> Params:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _init(gen, (d, h * dh), device=device, dtype=dtype),
        "wk": _init(gen, (d, hk * dh), device=device, dtype=dtype),
        "wv": _init(gen, (d, hk * dh), device=device, dtype=dtype),
        "wo": _init(gen, (h * dh, d), device=device, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=device)
    return p


def _attend_chunked(
    q: torch.Tensor,            # (B, Sq, H, Dh)
    k: torch.Tensor,            # (B, Sk, Hk, Dh)  Hk divides H
    v: torch.Tensor,            # (B, Sk, Hk, Dv)
    q_positions: torch.Tensor,  # (B, Sq)
    kv_positions: torch.Tensor, # (B, Sk)
    kv_mask: Optional[torch.Tensor],  # (B, Sk) valid mask or None
    causal: bool,
    q_chunk: int,
    scores_f32: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scores, scale (default ``1/sqrt(Dh)``), mask and softmax in float32
    with ``scores_f32``, else in ``v.dtype`` (the reference's
    ``preferred_element_type``); the value product in the compute dtype."""
    b, sq, h, dh = q.shape
    hk = k.shape[2]
    dv = v.shape[3]
    rep = h // hk
    acc_dt = torch.float32 if scores_f32 else v.dtype
    scale = torch.tensor(1.0 / math.sqrt(dh) if scale is None else scale,
                         dtype=acc_dt)
    qc = min(q_chunk, sq)
    k_acc = k.to(acc_dt)
    outs = []
    for lo in range(0, sq, qc):
        qi = q[:, lo:lo + qc].reshape(b, -1, hk, rep, dh)   # (B, qc, Hk, rep, Dh)
        qpi = q_positions[:, lo:lo + qc]
        s = torch.einsum("bqhrd,bkhd->bhrqk", qi.to(acc_dt), k_acc) * scale
        if causal:
            cm = (qpi[:, None, None, :, None]
                  >= kv_positions[:, None, None, None, :])
            s = torch.where(cm, s, MASK_VALUE)
        if kv_mask is not None:
            s = torch.where(kv_mask[:, None, None, None, :], s, MASK_VALUE)
        if scores_f32:
            p = torch.softmax(s, dim=-1).to(v.dtype)
        else:   # jax.nn.softmax's steps, each rounded to the scores' dtype
            e = torch.exp(s - s.amax(dim=-1, keepdim=True))
            p = e / e.sum(dim=-1, keepdim=True)
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
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _kv_share(cfg: AttnConfig, mesh) -> int:
    """The ``model`` ranks that share one KV head's columns (1 where each
    rank holds whole KV heads). The heads must split evenly either way."""
    m = PL.size_of(mesh, ("model",))
    h, hk = cfg.n_heads, cfg.n_kv_heads
    if h % m or (hk % m and m % hk):
        raise ValueError(f"{h} query / {hk} KV heads do not split over "
                         f"{m} model ranks")
    return m // hk if m > hk else 1


def _qkv_local(params: Params, x: torch.Tensor, positions: torch.Tensor,
               cfg: AttnConfig, mesh
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """This rank's q heads and the whole KV heads they read (gathered from
    the ranks that share a head), normed and rope'd, and the share."""
    b, s, _ = x.shape
    dh, dt = cfg.head_dim, x.dtype
    share = _kv_share(cfg, mesh)
    q = (x @ params["wq"].to(dt)).reshape(b, s, -1, dh)
    k = PL.gather_within(x @ params["wk"].to(dt), -1, mesh, "model", share)
    v = PL.gather_within(x @ params["wv"].to(dt), -1, mesh, "model", share)
    k, v = k.reshape(b, s, -1, dh), v.reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, share


def own_columns(kv: torch.Tensor, share: int, mesh) -> torch.Tensor:
    """This rank's column block (B, S, Hk*Dh / model) of the whole KV heads
    ``kv`` (B, S, heads, Dh) that ``_qkv_local`` returned."""
    b, s = kv.shape[:2]
    flat = kv.reshape(b, s, -1)
    if share == 1:
        return flat
    c = flat.shape[-1] // share
    return flat.narrow(-1, (PL.rank_of(mesh, ("model",)) % share) * c, c)


def gqa_local(params: Params, x: torch.Tensor, positions: torch.Tensor,
              cfg: AttnConfig, mesh, causal: bool = True,
              kv_mask: Optional[torch.Tensor] = None):
    """Rank-local self-attention: (this rank's part of the output, summed
    over ``model`` by the caller; its own k and v columns)."""
    b, s, _ = x.shape
    q, k, v, share = _qkv_local(params, x, positions, cfg, mesh)
    out = _attend_chunked(q, k, v, positions, positions, kv_mask, causal,
                          cfg.q_chunk, cfg.scores_f32)
    part = out.reshape(b, s, -1) @ params["wo"].to(x.dtype)
    return part, own_columns(k, share, mesh), own_columns(v, share, mesh)


def gqa_attention(
    params: Params,
    x: torch.Tensor,                    # (B, S, D)
    positions: torch.Tensor,            # (B, S)
    cfg: AttnConfig,
    causal: bool = True,
    kv_mask: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Self-attention over x (training / prefill)."""
    b, s, _ = x.shape
    if PL.tp(mesh):
        part = gqa_local(params, x, positions, cfg, mesh, causal, kv_mask)[0]
        return PL.sum_over(part, mesh, ("model",))
    q, k, v = _qkv(params, x, positions, cfg)
    out = _attend_chunked(q, k, v, positions, positions, kv_mask, causal,
                          cfg.q_chunk, cfg.scores_f32)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ params["wo"].to(x.dtype)


def _write_at(cache: torch.Tensor, entry: torch.Tensor,
              position: torch.Tensor) -> torch.Tensor:
    """Write each row's one-token ``entry`` (B, 1, ...) into ``cache`` (B,
    S, ...) at ``position`` (B,), in place, the start clamped into
    ``[0, S-1]`` as ``dynamic_update_slice`` clamps it."""
    b = cache.shape[0]
    pos = position.long().clamp(0, cache.shape[1] - 1)
    cache[torch.arange(b, device=cache.device), pos] = entry[:, 0].to(
        cache.dtype)
    return cache


def _decode_mask(position: torch.Tensor, skv: int) -> torch.Tensor:
    """(B, Skv): the cache entries at or before each row's position."""
    return (torch.arange(skv, device=position.device)[None, :]
            <= position.reshape(-1, 1))


def _seq_start(skv_local: int, mesh, seq_axes) -> int:
    """The global position of this rank's first cache entry."""
    return PL.rank_of(mesh, seq_axes) * skv_local


def write_owned(cache: torch.Tensor, entry: torch.Tensor,
                position: torch.Tensor, mesh, seq_axes) -> torch.Tensor:
    """``_write_at`` on a cache whose positions are blocked over
    ``seq_axes``: the start is clamped into the GLOBAL cache, and only the
    rank whose block holds it writes (the others write back what they
    hold)."""
    b, s_loc = cache.shape[:2]
    lo = _seq_start(s_loc, mesh, seq_axes)
    pos = position.long().clamp(0, s_loc * PL.size_of(mesh, seq_axes) - 1)
    own = (pos >= lo) & (pos < lo + s_loc)
    idx = (pos - lo).clamp(0, s_loc - 1)
    rows = torch.arange(b, device=cache.device)
    new = entry[:, 0].to(cache.dtype)
    own = own.reshape(b, *([1] * (new.ndim - 1)))
    cache[rows, idx] = torch.where(own, new, cache[rows, idx])
    return cache


def local_decode_mask(position: torch.Tensor, skv_local: int, mesh,
                      seq_axes) -> torch.Tensor:
    """(B, Skv_local): this rank's cache entries at or before each row's
    position (``_decode_mask`` over the global positions)."""
    lo = _seq_start(skv_local, mesh, seq_axes)
    return (lo + torch.arange(skv_local, device=position.device)[None, :]
            <= position.reshape(-1, 1))


def _merge_heads(scores: torch.Tensor, values, mesh, seq_axes, out_eq: str
                 ) -> torch.Tensor:
    """Softmax over this rank's positions and the log-sum-exp combine over
    ``seq_axes``: ``scores`` (..., Skv_local) float32 with the heads first
    (B, heads..., 1, Skv), ``out_eq`` the einsum of the weights with
    ``values`` to (B, 1, heads..., Dv)."""
    m, e, s = PL.softmax_partials(scores)
    o = torch.einsum(out_eq, e.to(values.dtype), values)
    nh = scores.ndim - 3            # head dims between B and the query dim

    def to_o(t):                    # (B, heads.., 1, 1) -> (B, 1, heads.., 1)
        return t.movedim(nh + 1, 1)

    return PL.merge_partials(m, s, o, mesh, seq_axes, to_o)


def gqa_decode_local(params: Params, x: torch.Tensor, position: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cfg: AttnConfig, mesh, seq_axes) -> torch.Tensor:
    """Rank-local ``gqa_decode`` over a cache blocked by position over
    ``seq_axes`` and holding every KV head: the token's q, k and v columns
    gathered over ``model`` (one token a row), the entry written by its
    owner, attention over this rank's positions for every head, the
    partials merged, and this rank's heads through its rows of ``wo``.
    Returns this rank's part of the output (summed over ``model`` by the
    caller)."""
    b = x.shape[0]
    h, hk, dh, dt = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, x.dtype
    m_ax = ("model",)
    q = PL.gather_over(x @ params["wq"].to(dt), -1, mesh, m_ax)
    k = PL.gather_over(x @ params["wk"].to(dt), -1, mesh, m_ax)
    v = PL.gather_over(x @ params["wv"].to(dt), -1, mesh, m_ax)
    q, k, v = (q.reshape(b, 1, h, dh), k.reshape(b, 1, hk, dh),
               v.reshape(b, 1, hk, dh))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, position, cfg.rope_theta)
    k = apply_rope(k, position, cfg.rope_theta)
    write_owned(k_cache, k, position[:, 0], mesh, seq_axes)
    write_owned(v_cache, v, position[:, 0], mesh, seq_axes)
    mask = local_decode_mask(position, k_cache.shape[1], mesh, seq_axes)
    qi = q.reshape(b, 1, hk, h // hk, dh).float()
    s = torch.einsum("bqhrd,bkhd->bhrqk", qi, k_cache.float()) * (
        1.0 / math.sqrt(dh))
    s = torch.where(mask[:, None, None, None, :], s, MASK_VALUE)
    out = _merge_heads(s, v_cache, mesh, seq_axes, "bhrqk,bkhd->bqhrd")
    out = PL.block(out.to(dt).reshape(b, 1, h * dh), -1, mesh, m_ax)
    return out @ params["wo"].to(dt)


def gqa_decode(
    params: Params,
    x: torch.Tensor,              # (B, 1, D) new token
    position: torch.Tensor,       # (B, 1) its position
    k_cache: torch.Tensor,        # (B, Skv, Hk, Dh) rope'd cached keys
    v_cache: torch.Tensor,        # (B, Skv, Hk, Dh)
    cfg: AttnConfig,
    mesh=None,
    seq_axes=(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step: insert the new token's KV at ``position`` (in
    place) and attend against the full cache. Returns (out, k_cache,
    v_cache). On a mesh the caches are this rank's block of positions over
    ``seq_axes`` (``gqa_decode_local``)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"gqa_decode takes one token a row, got {s}")
    if PL.tp(mesh):
        out = gqa_decode_local(params, x, position, k_cache, v_cache, cfg,
                               mesh, seq_axes)
        return PL.sum_over(out, mesh, ("model",)), k_cache, v_cache
    q, k_new, v_new = _qkv(params, x, position, cfg)
    k_cache = _write_at(k_cache, k_new, position[:, 0])
    v_cache = _write_at(v_cache, v_new, position[:, 0])
    skv = k_cache.shape[1]
    kv_mask = _decode_mask(position, skv)
    kvp = torch.arange(skv, device=x.device)[None, :].expand(b, skv)
    out = _attend_chunked(q, k_cache, v_cache, position, kvp, kv_mask, False,
                          cfg.q_chunk)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ params["wo"].to(x.dtype)
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                device="cuda", dtype: torch.dtype = torch.float32) -> Params:
    return {
        "w_gate": _init(gen, (d_model, d_ff), device=device, dtype=dtype),
        "w_up": _init(gen, (d_model, d_ff), device=device, dtype=dtype),
        "w_down": _init(gen, (d_ff, d_model), device=device, dtype=dtype),
    }


def swiglu(params: Params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """On a mesh: this rank's gate/up columns and down rows, summed over
    ``model``."""
    dt = x.dtype
    g = F.silu(x @ params["w_gate"].to(dt))
    u = x @ params["w_up"].to(dt)
    out = (g * u) @ params["w_down"].to(dt)
    return PL.sum_over(out, mesh, ("model",)) if PL.tp(mesh) else out


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention, DeepSeek-V2): compressed KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 1e4
    q_chunk: int = 1024
    yarn: Optional[YaRN] = None

    @property
    def softmax_scale(self) -> float:
        """``(nope + rope)^-1/2``, times YaRN's ``mscale^2`` if stretched."""
        scale = 1.0 / math.sqrt(self.qk_nope_dim + self.qk_rope_dim)
        return scale if self.yarn is None else (
            scale * self.yarn.attention_scale())


def init_mla(gen: torch.Generator, cfg: MLAConfig, device="cuda",
             dtype: torch.dtype = torch.float32) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    r = cfg.kv_lora_rank

    def w(shape):
        return _init(gen, shape, device=device, dtype=dtype)

    return {
        "wq": w((d, h * qd)),
        "w_dkv": w((d, r)),                          # compress
        "w_k_rope": w((d, cfg.qk_rope_dim)),         # shared rope key
        "w_uk": w((r, h * cfg.qk_nope_dim)),
        "w_uv": w((r, h * cfg.v_head_dim)),
        "wo": w((h * cfg.v_head_dim, d)),
        "kv_norm": torch.ones((r,), dtype=dtype, device=device),
    }


def _mla_q(params: Params, x: torch.Tensor, positions: torch.Tensor,
           cfg: MLAConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope, q_pe), q_pe rope'd: (B, S, H, nope) and (B, S, H, rope)
    (H is this rank's heads on a mesh)."""
    b, s, _ = x.shape
    q = (x @ params["wq"].to(x.dtype)).reshape(
        b, s, -1, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_pe = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta, cfg.yarn)


def mla_new_cache_entries(params: Params, x: torch.Tensor,
                          positions: torch.Tensor, cfg: MLAConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed cache entries for new tokens: (c_kv, k_pe)."""
    dt = x.dtype
    c_kv = rms_norm(x @ params["w_dkv"].to(dt), params["kv_norm"])
    k_pe = apply_rope((x @ params["w_k_rope"].to(dt))[:, :, None, :],
                      positions, cfg.rope_theta, cfg.yarn)[:, :, 0, :]
    return c_kv, k_pe


def mla_attention_train(
    params: Params,
    x: torch.Tensor,              # (B, S, D)
    positions: torch.Tensor,      # (B, S)
    cfg: MLAConfig,
    mesh=None,
    kv_mask: Optional[torch.Tensor] = None,   # (B, S) keys that count
) -> torch.Tensor:
    """Training/prefill path: decompress K/V and run standard causal MHA
    (on a mesh: this rank's heads, whose ``w_uk``/``w_uv`` columns it
    holds, then ``wo``'s rows and the sum over ``model``). Keys outside
    ``kv_mask`` (left padding) are masked."""
    b, s, _ = x.shape
    h = cfg.n_heads // PL.size_of(mesh, ("model",)) if PL.tp(mesh) \
        else cfg.n_heads
    dt = x.dtype
    q_nope, q_pe = _mla_q(params, x, positions, cfg)
    c_kv, k_pe = mla_new_cache_entries(params, x, positions, cfg)
    k_nope = (c_kv @ params["w_uk"].to(dt)).reshape(b, s, h, cfg.qk_nope_dim)
    v = (c_kv @ params["w_uv"].to(dt)).reshape(b, s, h, cfg.v_head_dim)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_dim)], dim=-1)
    out = _attend_chunked(q_full, k_full, v, positions, positions, kv_mask,
                          True, cfg.q_chunk, scale=cfg.softmax_scale)
    out = out.reshape(b, s, h * cfg.v_head_dim) @ params["wo"].to(dt)
    return PL.sum_over(out, mesh, ("model",)) if PL.tp(mesh) else out


def mla_attention_decode(
    params: Params,
    x: torch.Tensor,              # (B, 1, D)
    position: torch.Tensor,       # (B, 1)
    c_kv_cache: torch.Tensor,     # (B, Skv, r) compressed latents (normed)
    k_pe_cache: torch.Tensor,     # (B, Skv, rope)
    kv_mask: torch.Tensor,        # (B, Skv)
    cfg: MLAConfig,
    mesh=None,
    seq_axes=(),
) -> torch.Tensor:
    """Decode path with the absorbed-matmul trick: score against the
    compressed latents directly; W_uk/W_uv are absorbed into the query and
    output sides, so a cached token reads r + rope values instead of
    2*H*Dh. Scores and softmax in float32. On a mesh the caches are this
    rank's block of positions over ``seq_axes`` (``kv_mask`` its part of
    the mask): ``mla_decode_local``."""
    if PL.tp(mesh):
        return PL.sum_over(mla_decode_local(
            params, x, position, c_kv_cache, k_pe_cache, kv_mask, cfg, mesh,
            seq_axes), mesh, ("model",))
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dt = x.dtype
    q_nope, q_pe = _mla_q(params, x, position, cfg)
    w_uk = params["w_uk"].to(dt).reshape(r, h, cfg.qk_nope_dim)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)        # absorb W_uk
    s_lat = torch.einsum("bshr,bkr->bhsk", q_lat.float(), c_kv_cache.float())
    s_pe = torch.einsum("bshn,bkn->bhsk", q_pe.float(), k_pe_cache.float())
    scores = (s_lat + s_pe) * cfg.softmax_scale
    scores = torch.where(kv_mask[:, None, None, :], scores, MASK_VALUE)
    p = torch.softmax(scores, dim=-1).to(dt)
    o_lat = torch.einsum("bhsk,bkr->bshr", p, c_kv_cache.to(dt))  # (B,1,H,r)
    w_uv = params["w_uv"].to(dt).reshape(r, h, cfg.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv)           # absorb W_uv
    return out.reshape(b, s, h * cfg.v_head_dim) @ params["wo"].to(dt)


def mla_decode_local(params: Params, x: torch.Tensor, position: torch.Tensor,
                     c_kv_cache: torch.Tensor, k_pe_cache: torch.Tensor,
                     kv_mask: torch.Tensor, cfg: MLAConfig, mesh, seq_axes
                     ) -> torch.Tensor:
    """Rank-local absorbed MLA decode: this rank's heads' latent queries
    (its ``w_uk`` columns), gathered over ``model`` with their rope parts;
    every head scored against this rank's positions, the partials merged
    over ``seq_axes``; this rank's heads through its ``w_uv`` columns and
    ``wo`` rows. Returns its part of the output."""
    b = x.shape[0]
    r, dt = cfg.kv_lora_rank, x.dtype
    m_ax = ("model",)
    q_nope, q_pe = _mla_q(params, x, position, cfg)         # (B,1,H_loc,.)
    h_loc = q_nope.shape[2]
    w_uk = params["w_uk"].to(dt).reshape(r, h_loc, cfg.qk_nope_dim)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
    q_lat = PL.gather_over(q_lat, 2, mesh, m_ax)             # (B,1,H,r)
    q_pe = PL.gather_over(q_pe, 2, mesh, m_ax)
    s_lat = torch.einsum("bshr,bkr->bhsk", q_lat.float(), c_kv_cache.float())
    s_pe = torch.einsum("bshn,bkn->bhsk", q_pe.float(), k_pe_cache.float())
    scores = torch.where(kv_mask[:, None, None, :],
                         (s_lat + s_pe) * cfg.softmax_scale,
                         MASK_VALUE)
    o_lat = _merge_heads(scores, c_kv_cache.to(dt), mesh, seq_axes,
                         "bhsk,bkr->bshr").to(dt)            # (B,1,H,r)
    o_lat = PL.block(o_lat, 2, mesh, m_ax)
    w_uv = params["w_uv"].to(dt).reshape(r, h_loc, cfg.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv)
    return out.reshape(b, 1, h_loc * cfg.v_head_dim) @ params["wo"].to(dt)


# ---------------------------------------------------------------------------
# stacked layers (the reference's ``jax.vmap(block_init)`` layout)
# ---------------------------------------------------------------------------

def stack_blocks(n: int, make_block) -> Params:
    """``n`` blocks from ``make_block()`` stacked on axis 0, filled layer by
    layer into preallocated leaves: the peak is the stack and one block."""
    first = make_block()
    flat = tree_leaves(first)
    stacked = [torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
               for t in flat]
    for i in range(n):
        block = first if i == 0 else make_block()
        for dst, src in zip(stacked, tree_leaves(block)):
            dst[i].copy_(src)
        del block
    it = iter(stacked)
    return tree_map(lambda _: next(it), first)


def unstack(blocks: Params, n: int):
    """The ``n`` per-layer views of stacked ``blocks``, one ``unbind`` a
    leaf (its backward stacks the layers' gradients once, where indexing
    each layer would add a zero-padded full-size gradient per layer)."""
    flat = [t.unbind(0) for t in tree_leaves(blocks)]
    out = []
    for i in range(n):
        it = iter([ts[i] for ts in flat])
        out.append(tree_map(lambda _: next(it), blocks))
    return out
