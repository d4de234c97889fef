"""Plain reference of DLRM-UIH: its parameters, its inputs from a feed
batch, and its loss.

A frozen copy of the port's single-card DLRM-UIH (``models/recsys.py``,
``models/layers.py``, ``models/embedding.py``): a causal encoder over the
user's history (RMSNorm, RoPE attention with float32 scores chunked over
queries, SwiGLU), target-aware pooling with a float32 softmax, DLRM pairwise
interaction of the pooled history, the target, the dense projection and the
sparse fields, a top MLP and a float32 binary cross-entropy. Products run in
the configuration's compute dtype on float32 parameters; every operand of a
product passes ``Precision.q``. No recomputation in the backward pass (the
port's ``remat`` only trades memory for time).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from bench.reference.precision import Precision

MASK_VALUE = -1e30
ROPE_THETA = 1e4


def layout(cfg: dict):
    """(path, shape, init) of every parameter, in sorted-key order; init is
    ``("normal", scale)``, ``("zeros",)`` or ``("ones",)``."""
    d, e, n = cfg["d_seq"], cfg["embed_dim"], cfg["n_seq_layers"]
    n_inter = 3 + cfg["n_sparse"]
    d_pairs = n_inter * (n_inter - 1) // 2
    out = [(("action_table",), (16, d), ("normal", 0.01))]
    out += _mlp("dense_proj", [cfg["n_dense"], e])
    out += [(("item_table",), (cfg["item_vocab"], d), ("normal", 0.01))]
    s = 1.0 / math.sqrt(d)
    for w in ("wk", "wo", "wq", "wv"):
        out.append((("seq_blocks", "attn", w), (n, d, d), ("normal", s)))
    out += [(("seq_blocks", "ffn", "w_down"), (n, 4 * d, d),
             ("normal", 1.0 / math.sqrt(4 * d))),
            (("seq_blocks", "ffn", "w_gate"), (n, d, 4 * d), ("normal", s)),
            (("seq_blocks", "ffn", "w_up"), (n, d, 4 * d), ("normal", s)),
            (("seq_blocks", "ln1"), (n, d), ("ones",)),
            (("seq_blocks", "ln2"), (n, d), ("ones",)),
            (("seq_ln",), (d,), ("ones",))]
    out += _mlp("seq_proj", [d, e])
    out += [(("sparse_tables",), (cfg["n_sparse"] * cfg["field_vocab"], e),
             ("normal", 0.01))]
    out += _mlp("target_proj", [d, e])
    out += _mlp("top_mlp", [d_pairs + e, *cfg["top_mlp"], 1])
    return sorted(out)


def _mlp(name: str, dims):
    out = []
    for i in range(len(dims) - 1):
        out.append(((name, f"w{i}"), (dims[i], dims[i + 1]),
                    ("normal", 1.0 / math.sqrt(dims[i]))))
        out.append(((name, f"b{i}"), (dims[i + 1],), ("zeros",)))
    return out


def prep(batch: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    """The model's inputs from a dense feed batch: ids modulo the tables'
    rows, sparse fields cycling the user and the candidate, the history's
    fill as the dense features, the click label."""
    mask = batch["uih_mask"]
    n_sparse, n_dense, fv = cfg["n_sparse"], cfg["n_dense"], cfg["field_vocab"]
    sources = (batch["user_id"], batch["cand_item_id"])
    sparse = torch.stack([sources[i % 2] % fv for i in range(n_sparse)],
                         dim=1).to(torch.int32)
    dense = torch.stack([mask.sum(1)] * n_dense, dim=1).float() / mask.shape[1]
    iv = cfg["item_vocab"]
    return {
        "uih_item_id": (batch["uih_item_id"] % iv).to(torch.int32),
        "uih_action_type": (batch["uih_action_type"] % 16).to(torch.int32),
        "uih_mask": mask,
        "cand_item_id": (batch["cand_item_id"] % iv).to(torch.int32),
        "sparse_ids": sparse,
        "dense": dense,
        "label": batch["label_click"].float(),
    }


def _rms_norm(x, w, eps=1e-6):
    x32 = x.float()
    out = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (out * w.float()).to(x.dtype)


def _rope(x, positions):
    dh = x.shape[-1]
    freqs = 1.0 / (ROPE_THETA ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                               device=x.device) / dh))
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attention(blk, x, positions, mask, cfg, P: Precision):
    b, s, d = x.shape
    h = cfg["n_heads"]
    dh = d // h
    q = (P.q(x) @ P.cast(blk["wq"])).reshape(b, s, h, dh)
    k = (P.q(x) @ P.cast(blk["wk"])).reshape(b, s, h, dh)
    v = (P.q(x) @ P.cast(blk["wv"])).reshape(b, s, h, dh)
    q, k = _rope(q, positions), _rope(k, positions)
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    kf = P.q(k.float())
    outs = []
    qc = min(cfg["q_chunk"], s)
    for lo in range(0, s, qc):
        qi = q[:, lo:lo + qc].reshape(b, -1, h, 1, dh)
        sc = torch.einsum("bqhrd,bkhd->bhrqk", P.q(qi.float()), kf) * scale
        cm = positions[:, None, None, lo:lo + qc, None] >= positions[
            :, None, None, None, :]
        sc = torch.where(cm, sc, MASK_VALUE)
        sc = torch.where(mask[:, None, None, None, :], sc, MASK_VALUE)
        p = torch.softmax(sc, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhrqk,bkhd->bqhrd", P.q(p), P.q(v)))
    out = torch.cat(outs, dim=1).reshape(b, s, d)
    return P.q(out) @ P.cast(blk["wo"])


def _block(h, blk, positions, mask, cfg, P):
    h = h + _attention(blk["attn"], _rms_norm(h, blk["ln1"]), positions, mask,
                       cfg, P)
    hn = _rms_norm(h, blk["ln2"])
    f = blk["ffn"]
    g = F.silu(P.q(hn) @ P.cast(f["w_gate"]))
    u = P.q(hn) @ P.cast(f["w_up"])
    return h + P.q(g * u) @ P.cast(f["w_down"])


def _mlp_apply(p, x, n_layers, P: Precision, final_act=False):
    for i in range(n_layers):
        x = P.q(x) @ P.cast(p[f"w{i}"]) + p[f"b{i}"].to(x.dtype)
        if i < n_layers - 1 or final_act:
            x = torch.relu(x)
    return x


def _bce(logits, labels):
    logits, labels = logits.float(), labels.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def logits(params, batch, cfg: dict, P: Precision) -> torch.Tensor:
    dt = P.dtype
    ids = batch["uih_item_id"]
    h = (P.cast(params["item_table"][ids])
         + P.cast(params["action_table"][batch["uih_action_type"]]))
    mask = batch["uih_mask"]
    b, s = h.shape[:2]
    positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    blocks = params["seq_blocks"]
    for i in range(cfg["n_seq_layers"]):
        blk = {"attn": {k: v[i] for k, v in blocks["attn"].items()},
               "ffn": {k: v[i] for k, v in blocks["ffn"].items()},
               "ln1": blocks["ln1"][i], "ln2": blocks["ln2"][i]}
        h = _block(h, blk, positions, mask, cfg, P)
    h = _rms_norm(h, params["seq_ln"])
    tgt = P.cast(params["item_table"][batch["cand_item_id"]])
    att = torch.einsum("bsd,bd->bs", P.q(h.float()), P.q(tgt.float()))
    att = torch.softmax(torch.where(mask, att / math.sqrt(cfg["d_seq"]),
                                    MASK_VALUE), dim=-1).to(dt)
    user_seq = torch.einsum("bs,bsd->bd", P.q(att), P.q(h))
    sp = batch["sparse_ids"]
    offs = torch.arange(cfg["n_sparse"], device=sp.device) * cfg["field_vocab"]
    sparse = P.cast(params["sparse_tables"][sp + offs])
    dense = _mlp_apply(params["dense_proj"], batch["dense"].to(dt), 1, P)
    feats = torch.stack([_mlp_apply(params["seq_proj"], user_seq, 1, P),
                         _mlp_apply(params["target_proj"], tgt, 1, P), dense]
                        + [sparse[:, i] for i in range(cfg["n_sparse"])],
                        dim=1)
    inter = torch.einsum("bfd,bgd->bfg", P.q(feats), P.q(feats))
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
    z = torch.cat([inter[:, iu, ju], dense], dim=-1)
    return _mlp_apply(params["top_mlp"], z, len(cfg["top_mlp"]) + 1, P)[:, 0]


def loss(params, batch, cfg: dict, P: Precision) -> torch.Tensor:
    return _bce(logits(params, batch, cfg, P), batch["label"])


def meta_inputs(cfg: dict, rows: int, seq_len: int, device="meta"):
    """Model inputs of ``rows`` examples at ``seq_len``, shapes only."""
    i32 = torch.int32
    return {
        "uih_item_id": torch.zeros((rows, seq_len), dtype=i32, device=device),
        "uih_action_type": torch.zeros((rows, seq_len), dtype=i32,
                                       device=device),
        "uih_mask": torch.ones((rows, seq_len), dtype=torch.bool,
                               device=device),
        "cand_item_id": torch.zeros((rows,), dtype=i32, device=device),
        "sparse_ids": torch.zeros((rows, cfg["n_sparse"]), dtype=i32,
                                  device=device),
        "dense": torch.zeros((rows, cfg["n_dense"]), device=device),
        "label": torch.zeros((rows,), device=device),
    }
