"""Plain reference of DeepSeek-V2-Lite as a generative recommender: one
card's share of its experts, its parameters, its inputs from a feed batch,
and its loss.

The model (arXiv:2405.04434; the published config.json): token embedding;
``first_k_dense_replace`` dense layers and then MoE layers, each RMSNorm ->
multi-head latent attention (no q LoRA; the keys and values from a
``kv_lora_rank`` latent, RMS-normed; a shared rope key) -> RMSNorm -> FFN;
a final RMSNorm and an untied unembedding. Attention is causal, its rope
part stretched by YaRN (``rope_scaling``, as the published modelling code
computes the frequencies and the softmax scale ``mscale(all_dim)^2 /
sqrt(nope + rope)``). An MoE layer's gate is the softmax score of its
greedy top-k over all the router's experts (no renormalisation, scale 1),
and its output the held experts' gated SwiGLUs plus the shared experts'
SwiGLU; the sequence-level balance loss ``alpha * mean_b sum_i f_bi P_bi``
of every MoE layer is added to the mean next-token cross-entropy.

The share: the configuration's ``n_routed_experts`` experts are held,
from ``deployment.first_held`` of the router's ``deployment.router_experts``;
what the others would add is left out. The held experts run densely over
every token with a zero gate off its top-k, so every shape is static (the
program computes each held pair once).

Departures from the published model, each also in PERF.md:
* the rope dimensions rotate as two halves (the published code pairs
  interleaved dimensions): a fixed permutation of random weights;
* positions outside the history's mask (left padding) are masked as keys
  and left out of the loss and of the balance statistics, whose means run
  over each sequence's valid positions;
* the tokens are the history's item ids, the target of the last position
  the candidate's.

Products run in the configuration's compute dtype on float32 parameters;
the router, its softmax, the attention scores and the loss in float32;
every operand of a product passes ``Precision.q``. On a real device each
layer and each loss chunk is recomputed in the backward pass
(``torch.utils.checkpoint``: memory only, the same arithmetic); on the
``meta`` device, where the benchmark counts FLOPs, nothing is.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.precision import Precision

MASK_VALUE = -1e30


def _dims(cfg: dict) -> dict:
    return {"d": cfg["hidden_size"], "h": cfg["num_attention_heads"],
            "r": cfg["kv_lora_rank"], "nope": cfg["qk_nope_head_dim"],
            "rope": cfg["qk_rope_head_dim"], "v": cfg["v_head_dim"],
            "dff": cfg["intermediate_size"],
            "f": cfg["moe_intermediate_size"],
            "held": cfg["n_routed_experts"],
            "fs": cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
            "E": cfg["deployment"]["router_experts"],
            "first": cfg["deployment"]["first_held"],
            "k": cfg["num_experts_per_tok"], "V": cfg["vocab_size"],
            "dense": cfg["first_k_dense_replace"],
            "moe": cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]}


def layout(cfg: dict):
    """(path, shape, init) of every parameter, in sorted-key order; init is
    ``("normal", scale)``, ``("zeros",)`` or ``("ones",)``. The blocks of
    each kind are stacked on a leading layer axis."""
    m = _dims(cfg)
    d, h = m["d"], m["h"]

    def w(group, name, n, shape, scale=None):
        return ((group, *name), (n, *shape),
                ("normal", scale if scale is not None
                 else 1.0 / math.sqrt(shape[-2])))

    def attn(group, n):
        return [w(group, ("attn", "w_dkv"), n, (d, m["r"])),
                w(group, ("attn", "w_k_rope"), n, (d, m["rope"])),
                w(group, ("attn", "w_uk"), n, (m["r"], h * m["nope"])),
                w(group, ("attn", "w_uv"), n, (m["r"], h * m["v"])),
                w(group, ("attn", "wo"), n, (h * m["v"], d)),
                w(group, ("attn", "wq"), n, (d, h * (m["nope"] + m["rope"]))),
                ((group, "attn", "kv_norm"), (n, m["r"]), ("ones",)),
                ((group, "ln1"), (n, d), ("ones",)),
                ((group, "ln2"), (n, d), ("ones",))]

    n, nd = m["moe"], m["dense"]
    out = attn("blocks", n) + [
        w("blocks", ("ffn", "router"), n, (d, m["E"]), 0.02),
        w("blocks", ("ffn", "shared_w_in"), n, (d, 2 * m["fs"])),
        w("blocks", ("ffn", "shared_w_out"), n, (m["fs"], d)),
        w("blocks", ("ffn", "w_in"), n, (m["held"], d, 2 * m["f"])),
        w("blocks", ("ffn", "w_out"), n, (m["held"], m["f"], d))]
    if nd:
        out += attn("dense_blocks", nd) + [
            w("dense_blocks", ("ffn", "w_down"), nd, (m["dff"], d)),
            w("dense_blocks", ("ffn", "w_gate"), nd, (d, m["dff"])),
            w("dense_blocks", ("ffn", "w_up"), nd, (d, m["dff"]))]
    out += [(("embed",), (m["V"], d), ("normal", 0.02)),
            (("final_norm",), (d,), ("ones",)),
            (("unembed",), (m["V"], d), ("normal", 0.02))]
    return sorted(out)


def prep(batch: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    """Next-item prediction over a dense feed batch: the history's item ids
    as tokens, the next event's item as each position's target (the
    candidate's at the last position), the history's mask."""
    tokens = batch["uih_item_id"].long()
    targets = torch.cat([tokens[:, 1:], batch["cand_item_id"].long()[:, None]],
                        dim=1)
    return {"tokens": tokens, "targets": targets, "mask": batch["uih_mask"]}


def meta_inputs(cfg: dict, rows: int, seq_len: int, device="meta"):
    """Model inputs of ``rows`` sequences of ``seq_len``, shapes only."""
    i64 = torch.int64
    return {"tokens": torch.zeros((rows, seq_len), dtype=i64, device=device),
            "targets": torch.zeros((rows, seq_len), dtype=i64, device=device),
            "mask": torch.ones((rows, seq_len), dtype=torch.bool,
                               device=device)}


def yarn_frequencies(cfg: dict, device=None) -> torch.Tensor:
    """The rope part's inverse frequencies, stretched by YaRN as the
    published modelling code does (``yarn_find_correction_range``, the
    linear ramp, ``freq / factor`` blended with ``freq``)."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    ys = cfg["rope_scaling"]
    orig, factor = ys["original_max_position_embeddings"], ys["factor"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(ys["beta_fast"])), 0)
    high = min(math.ceil(corr(ys["beta_slow"])), dim - 1)
    freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low if high != low else 0.001)).clamp(0, 1)
    mask = 1.0 - ramp
    return freq / factor * (1 - mask) + freq * mask


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def softmax_scale(cfg: dict) -> float:
    ys = cfg["rope_scaling"]
    q_dim = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    m = _mscale(ys["factor"], ys["mscale_all_dim"])
    return q_dim ** -0.5 * m * m


def _rms_norm(x, w, eps):
    x32 = x.float()
    out = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (out * w.float()).to(x.dtype)


def _rope(x, positions, inv_freq, mscale: float = 1.0):
    ang = positions[..., None].float() * inv_freq
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attention(a, x, positions, mask, cfg, P: Precision):
    m = _dims(cfg)
    b, s, _ = x.shape
    h, nope, rope, vd = m["h"], m["nope"], m["rope"], m["v"]
    eps = cfg["rms_norm_eps"]
    inv_freq = yarn_frequencies(cfg, x.device)
    ys = cfg["rope_scaling"]
    ms = (_mscale(ys["factor"], ys["mscale"])
          / _mscale(ys["factor"], ys["mscale_all_dim"]))
    q = (P.q(x) @ P.cast(a["wq"])).reshape(b, s, h, nope + rope)
    q_nope, q_pe = torch.split(q, [nope, rope], dim=-1)
    q_pe = _rope(q_pe, positions, inv_freq, ms)
    c_kv = _rms_norm(P.q(x) @ P.cast(a["w_dkv"]), a["kv_norm"], eps)
    k_pe = _rope((P.q(x) @ P.cast(a["w_k_rope"]))[:, :, None, :], positions,
                 inv_freq, ms)
    k_nope = (P.q(c_kv) @ P.cast(a["w_uk"])).reshape(b, s, h, nope)
    v = (P.q(c_kv) @ P.cast(a["w_uv"])).reshape(b, s, h, vd)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, s, h, rope)], dim=-1)
    scale = torch.tensor(softmax_scale(cfg), dtype=torch.float32)
    kf = P.q(k.float())
    outs = []
    qc = min(cfg["q_chunk"], s)
    for lo in range(0, s, qc):
        qi = q[:, lo:lo + qc]
        sc = torch.einsum("bqhd,bkhd->bhqk", P.q(qi.float()), kf) * scale
        cm = positions[:, None, lo:lo + qc, None] >= positions[:, None, None, :]
        sc = torch.where(cm, sc, MASK_VALUE)
        sc = torch.where(mask[:, None, None, :], sc, MASK_VALUE)
        p = torch.softmax(sc, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", P.q(p), P.q(v)))
    out = torch.cat(outs, dim=1).reshape(b, s, h * vd)
    return P.q(out) @ P.cast(a["wo"])


def _swiglu_halves(x):
    g, u = torch.chunk(x, 2, dim=-1)
    return F.silu(g) * u


def balance_loss(probs, idx, mask, cfg: dict) -> torch.Tensor:
    """``alpha * mean_b sum_i f_bi P_bi`` over the valid positions of each
    sequence b (n_b of them; a sequence with none adds 0):
    ``f_bi = E / (K n_b) * #{(t, k): idx_tk = i}``, ``P_bi = mean_t
    probs_ti``; ``probs`` (B, S, E), ``idx`` (B, S, K)."""
    e, k = probs.shape[-1], idx.shape[-1]
    w = mask.to(probs.dtype)
    n = w.sum(1).clamp(min=1.0)[:, None]
    hits = (idx[..., None] == torch.arange(e, device=idx.device)).sum(2)
    f = (hits.to(probs.dtype) * w[..., None]).sum(1) * (e / k) / n
    p = (probs * w[..., None]).sum(1) / n
    return cfg["aux_loss_alpha"] * (f * p).sum(-1).mean()


def _moe(f, x, mask, cfg, P: Precision):
    """(the layer's output, its balance loss)."""
    m = _dims(cfg)
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax(P.q(xt.float()) @ P.q(f["router"].float()), dim=-1)
    gate, idx = torch.topk(probs, m["k"], dim=-1)
    held = m["first"] + torch.arange(m["held"], device=x.device)
    dense_gate = ((idx[..., None] == held) * gate[..., None]).sum(1)  # (T, E_h)
    hid = _swiglu_halves(torch.einsum("td,edf->etf", P.q(xt),
                                      P.cast(f["w_in"])))
    y = torch.einsum("etf,efd->etd", P.q(hid), P.cast(f["w_out"]))
    routed = (y.float() * dense_gate.T[..., None]).sum(0).to(x.dtype)
    hs = _swiglu_halves(P.q(xt) @ P.cast(f["shared_w_in"]))
    out = routed + P.q(hs) @ P.cast(f["shared_w_out"])
    aux = balance_loss(probs.reshape(b, s, -1), idx.reshape(b, s, -1), mask,
                       cfg)
    return out.reshape(b, s, d), aux


def _dense_ffn(f, x, P: Precision):
    g = F.silu(P.q(x) @ P.cast(f["w_gate"]))
    u = P.q(x) @ P.cast(f["w_up"])
    return P.q(g * u) @ P.cast(f["w_down"])


def _block(h, blk, positions, mask, cfg, P, dense: bool):
    eps = cfg["rms_norm_eps"]
    h = h + _attention(blk["attn"], _rms_norm(h, blk["ln1"], eps), positions,
                       mask, cfg, P)
    hn = _rms_norm(h, blk["ln2"], eps)
    if dense:
        return h + _dense_ffn(blk["ffn"], hn, P), torch.zeros(
            (), device=h.device)
    out, aux = _moe(blk["ffn"], hn, mask, cfg, P)
    return h + out, aux


def _layer(stack, i):
    return {k: (v[i] if isinstance(v, torch.Tensor) else _layer(v, i))
            for k, v in stack.items()}


def _xent(h, unembed, targets, w, P: Precision):
    logits = (P.q(h) @ P.cast(unembed).T).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.sum((logz - gold) * w)


def loss(params, batch, cfg: dict, P: Precision) -> torch.Tensor:
    """Mean cross-entropy over the valid positions plus every MoE layer's
    balance loss."""
    m = _dims(cfg)
    tokens, mask = batch["tokens"], batch["mask"]
    b, s = tokens.shape
    h = P.cast(params["embed"][tokens])
    positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    recompute = h.device.type != "meta"

    def run(fn, *args):
        return (checkpoint(fn, *args, use_reentrant=False) if recompute
                else fn(*args))

    aux = torch.zeros((), device=h.device)
    layers = [(params["dense_blocks"], i, True) for i in range(m["dense"])]
    layers += [(params["blocks"], i, False) for i in range(m["moe"])]
    for stack, i, dense in layers:
        h, a = run(lambda x, blk, d=dense: _block(x, blk, positions, mask,
                                                  cfg, P, d),
                   h, _layer(stack, i))
        aux = aux + a
    h = _rms_norm(h, params["final_norm"], cfg["rms_norm_eps"])
    w = mask.float()
    total = torch.zeros((), device=h.device)
    lc = min(cfg["loss_chunk"], s)
    for lo in range(0, s, lc):
        total = total + run(_xent, h[:, lo:lo + lc], params["unembed"],
                            batch["targets"][:, lo:lo + lc],
                            w[:, lo:lo + lc], P)
    return total / w.sum().clamp(min=1.0) + aux
