"""DeepSeek-V2-Lite as the benchmark trains it: one card's share of the
experts, dropless routing through the grouped expert product, YaRN, the
balance loss and left-padded histories, held against the plain reference
(``bench/reference/deepseek_v2.py``) at a small size on the CPU, float32
and seeded. The ``gpu`` tests hold the grouped kernel against its plain
version on the card and look for host syncs in the layer:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_dsv2_lite.py
"""
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.models import deepseek_v2 as adapter
from bench.reference import deepseek_v2 as R
from bench.reference import weights as W
from bench.reference.precision import Precision
from repro_torch.kernels.grouped_gemm import ops as gg
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.obs import Telemetry

SMALL = {
    "name": "dsv2_small", "family": "deepseek_v2", "hidden_size": 64,
    "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "intermediate_size": 96, "moe_intermediate_size": 32,
    "n_routed_experts": 4, "n_shared_experts": 1, "num_experts_per_tok": 3,
    "first_k_dense_replace": 1, "num_hidden_layers": 3, "vocab_size": 193,
    "norm_topk_prob": False, "routed_scaling_factor": 1,
    "scoring_func": "softmax", "topk_method": "greedy", "q_lora_rank": None,
    "moe_layer_freq": 1, "tie_word_embeddings": False, "rope_theta": 10000,
    "rms_norm_eps": 1e-6, "aux_loss_alpha": 0.001,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "compute_dtype": "float32", "remat": True, "q_chunk": 16,
    "loss_chunk": 16,
    "deployment": {"router_experts": 16, "first_held": 4},
}
B, S = 4, 32
F32 = Precision(dtype=torch.float32)


def _batch(seed=0, vocab=193):
    """A dense feed batch: left-padded histories of lengths 0 < n <= S."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.tensor([S, 20, 5, 1])
    mask = torch.arange(S)[None, :] >= (S - lens)[:, None]
    ids = torch.randint(0, vocab, (B, S), generator=g) * mask
    return {"uih_item_id": ids, "uih_mask": mask,
            "cand_item_id": torch.randint(0, vocab, (B,), generator=g)}


def _params(cfg, seed=5):
    _, tree = W.draw(R.layout(cfg), seed, "cpu")
    return W.as_parameters(tree)


def test_loss_and_every_gradient_match_the_reference():
    # float32 both sides; the orders of the sums differ (the held pairs
    # sorted and gathered against the reference's dense experts, the
    # combine's index_add), so agreement is to float32 rounding
    batch = _batch()
    out = []
    for side in ("port", "ref"):
        params = _params(SMALL)
        if side == "port":
            loss = adapter.program_loss(SMALL)(params, batch)
        else:
            loss = R.loss(params, R.prep(batch, SMALL), SMALL, F32)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in W.leaves(params)]))
    (lp, gp), (lr, grf) = out
    torch.testing.assert_close(lp, lr, rtol=1e-6, atol=0)
    names = W.leaf_names(R.layout(SMALL))
    for name, a, b in zip(names, gp, grf):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7, msg=name)
    assert all(g.abs().sum() > 0 for g in gp)


def test_lm_inputs_are_the_references():
    batch = _batch(1)
    tokens, targets, mask = T.history_lm_inputs(batch)
    want = R.prep(batch, SMALL)
    assert torch.equal(tokens, want["tokens"])
    assert torch.equal(targets, want["targets"])
    assert torch.equal(mask, want["mask"])
    assert torch.equal(targets[:, -1], batch["cand_item_id"])


def _moe_cfg(held=None, first=0, **kw):
    return M.MoEConfig(n_experts=16, top_k=3, d_ff=32, n_shared=1,
                       capacity_factor=None, n_held=held, first_held=first,
                       norm_topk_prob=False, **kw)


def _moe_params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return M.init_moe(g, 64, _moe_cfg(), device="cpu")


def _share(p, first, held):
    q = dict(p)
    q["w_in"] = p["w_in"][first:first + held]
    q["w_out"] = p["w_out"][first:first + held]
    return q


def _shared_part(p, x):
    return M._swiglu_halves(x @ p["shared_w_in"]) @ p["shared_w_out"]


def test_the_four_shares_add_up_to_the_uncut_layer():
    # each share routes over all 16 experts and computes its 4; the shared
    # expert, computed by every share, is counted once
    p = _moe_params(1)
    x = torch.randn(2, 24, 64, generator=torch.Generator().manual_seed(2))
    whole, _ = M.moe_dropless(p, x, _moe_cfg())
    parts = sum(M.moe_dropless(_share(p, f, 4), x, _moe_cfg(4, f))[0]
                for f in (0, 4, 8, 12))
    # float32: the routed parts are summed in another order
    torch.testing.assert_close(parts - 3 * _shared_part(p, x), whole,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(whole, M.moe_ref(p, x, _moe_cfg()),
                               rtol=1e-5, atol=1e-6)


def test_a_batch_routed_to_one_expert_drops_no_pair():
    p = _moe_params(3)
    p["router"] = p["router"].clone()
    p["router"][:, 6] += 50.0          # every token's best expert: 6
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(4)).abs()
    cfg = _moe_cfg(4, 4)
    M.STATS.reset()
    got, _ = M.moe_dropless(_share(p, 4, 4), x, cfg)
    counts = M.STATS.read()
    assert counts["tokens"] == 64 and counts["dropped"] == 0
    assert counts["max_expert_load"] == 64
    probs = torch.softmax(x @ p["router"], -1)
    gate, idx = torch.topk(probs, 3)
    assert bool((idx[:, 0] == 6).all())
    held = (idx >= 4) & (idx < 8)
    assert counts["pairs_held"] == int(held.sum())
    want = _shared_part(p, x)
    for t in range(64):
        for j in range(3):
            if held[t, j]:
                e = int(idx[t, j])
                hid = M._swiglu_halves(x[t] @ p["w_in"][e])
                want[t] += gate[t, j] * (hid @ p["w_out"][e])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_dropped_counts_the_pairs_a_short_row_bound_leaves_out(monkeypatch):
    # the counter is the router's held pairs less the rows the product ran:
    # a row bound one pair short of the held pairs must read 1 dropped
    p = _moe_params(3)
    p["router"] = p["router"].clone()
    p["router"][:, 6] += 50.0          # every token's best expert: 6
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(4)).abs()
    cfg = _moe_cfg(4, 4)
    gate, idx = torch.topk(torch.softmax(x @ p["router"], -1), 3)
    held = int(((idx >= 4) & (idx < 8)).sum())
    monkeypatch.setattr(M, "_held_rows", lambda t, c: held - 1)
    M.STATS.reset()
    M.moe_dropless(_share(p, 4, 4), x, cfg)
    counts = M.STATS.read()
    assert counts["dropped"] == 1 and counts["pairs_held"] == held - 1


def test_a_pad_token_changes_no_valid_output():
    batch = _batch(2)
    cfg = adapter.port_config(SMALL)
    params = _params(SMALL)
    outs = []
    for pad in (0, 117):
        b = dict(batch)
        ids = b["uih_item_id"].clone()
        ids[1, 0] = pad                 # row 1 holds 20 events: 0 is a pad
        b["uih_item_id"] = ids
        tokens, targets, mask = T.history_lm_inputs(b)
        with torch.no_grad():
            h, aux = T.hidden_states(params, tokens, cfg, mask=mask)
            loss = T.loss_fn(params, tokens, targets, cfg, mask=mask)
        outs.append((h[mask], aux, loss))
    # float32: the pad's own pairs change the expert groups' sizes, which
    # may change the order of a product's sums, never a valid input
    for a, b in zip(outs[0], outs[1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_yarn_against_the_closed_form_at_the_published_numbers():
    ys = L.YaRN(factor=40, original_max_position=4096, beta_fast=32,
                beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
    assert ys.correction_range(64, 1e4) == (10, 23)
    m = 0.1 * 0.707 * math.log(40) + 1
    mla = L.MLAConfig(d_model=2048, n_heads=16, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
                      yarn=ys)
    assert mla.softmax_scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert mla.softmax_scale == pytest.approx(0.11472, abs=5e-6)
    assert ys.cos_sin_scale() == 1.0
    i = np.arange(32)
    freq = 1e4 ** (-np.arange(0, 64, 2) / 64)
    keep = 1 - np.clip((i - 10) / 13, 0, 1)
    want = freq / 40 * (1 - keep) + freq * keep
    got = L.rope_frequencies(64, 1e4, yarn=ys).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    cfg = json.loads((Path(__file__).resolve().parents[1] / "bench"
                      / "configs" / "deepseek_v2_lite_ep8.json").read_text())
    np.testing.assert_allclose(R.yarn_frequencies(cfg).double().numpy(), want,
                               rtol=1e-6)
    assert R.softmax_scale(cfg) == pytest.approx(mla.softmax_scale,
                                                 rel=1e-12)


def test_balance_loss_against_the_formula():
    rng = np.random.default_rng(7)
    b, s, e, k = 3, 10, 16, 3
    probs = rng.random((b, s, e))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, -1)[..., :k]
    mask = rng.random((b, s)) < 0.6
    mask[2] = False                      # a sequence with no valid position
    want = 0.0
    for bi in range(b):
        n = mask[bi].sum()
        if not n:
            continue
        f = np.zeros(e)
        for t in range(s):
            if mask[bi, t]:
                for j in range(k):
                    f[idx[bi, t, j]] += e / (k * n)
        p = probs[bi][mask[bi]].mean(0)
        want += (f * p).sum()
    want = 0.001 * want / b
    args = (torch.from_numpy(probs), torch.from_numpy(idx),
            torch.from_numpy(mask))
    cfg = M.MoEConfig(n_experts=e, top_k=k, d_ff=8, aux_alpha=0.001)
    assert float(M.balance_loss(*args, cfg)) == pytest.approx(want, rel=1e-12)
    assert float(R.balance_loss(*args, {"aux_loss_alpha": 0.001})) == \
        pytest.approx(want, rel=1e-12)


def _groups():
    g = torch.Generator().manual_seed(9)
    off = torch.tensor([0, 5, 5, 17, 18, 30], dtype=torch.int64)
    a = torch.randn(34, 24, generator=g)       # 4 rows past the last group
    w = torch.randn(5, 24, 40, generator=g)
    return a, w, off


def test_grouped_gemm_plain_version_against_per_group_matmul():
    a, w, off = _groups()
    y = gg.grouped_gemm(a, w, off, gg.FWD)
    dy = torch.randn(34, 40)
    dx = gg.grouped_gemm(dy, w, off, gg.DX)
    dw = gg.grouped_gemm(a, dy, off, gg.DW)
    for g in range(5):
        lo, hi = int(off[g]), int(off[g + 1])
        torch.testing.assert_close(y[lo:hi], a[lo:hi] @ w[g])
        torch.testing.assert_close(dx[lo:hi], dy[lo:hi] @ w[g].T)
        torch.testing.assert_close(dw[g], a[lo:hi].T @ dy[lo:hi])
    assert not y[30:].any() and not dx[30:].any() and not dw[1].any()
    with pytest.raises(ValueError):
        gg.grouped_gemm(a, w[:4], off, gg.FWD)
    with pytest.raises(ValueError):
        gg.grouped_gemm(a, w, off.int(), gg.FWD)


def test_grouped_mm_autograd_against_per_group_matmul():
    a, w, off = _groups()
    a1, w1 = a.clone().requires_grad_(), w.clone().requires_grad_()
    a2, w2 = a.clone().requires_grad_(), w.clone().requires_grad_()
    dy = torch.randn(34, 40, generator=torch.Generator().manual_seed(1))
    (gg.grouped_mm(a1, w1, off) * dy).sum().backward()
    want = torch.cat([a2[int(off[g]):int(off[g + 1])] @ w2[g]
                      for g in range(5)] + [a2[30:] @ w2[0] * 0])
    (want * dy).sum().backward()
    torch.testing.assert_close(a1.grad, a2.grad)
    torch.testing.assert_close(w1.grad, w2.grad)


def _pairs(t=7, k=3, rows=15, d=24, seed=2):
    """``rows`` of a token's ``k`` pairs in a shuffled order (the first
    ``rows`` of a permutation of the ``t * k``, as the layer's sort leaves
    them), and bf16 rows a pair."""
    g = torch.Generator().manual_seed(seed)
    order = torch.randperm(t * k, generator=g)[:rows]
    return order, torch.randn(rows, d, generator=g).bfloat16()


def test_pair_gather_sums_each_token_once_in_float32():
    t, k = 7, 3
    order, dy = _pairs(t, k)
    x = torch.randn(t, 24).bfloat16().requires_grad_()
    y = M._PairGather.apply(x, order, k)
    assert torch.equal(y, x.detach().index_select(0, order // k))
    y.backward(dy)
    want = torch.zeros(t, 24, dtype=torch.float64).index_add(
        0, order // k, dy.double())
    # a token's pairs summed in float32 (exact for three bf16 rows of
    # these magnitudes) and rounded to bf16 once
    assert torch.equal(x.grad, want.bfloat16())


def test_combine_sums_each_token_in_float32():
    t, k = 7, 3
    order, y = _pairs(t, k)
    gate = torch.rand(len(order), generator=torch.Generator().manual_seed(3))
    got = M._combine_pairs(y, gate, order, t, k)
    want = torch.zeros(t, 24, dtype=torch.float64).index_add(
        0, order // k, y.double() * gate.double()[:, None])
    assert got.dtype == torch.float32
    # float32 products and sums of three terms: a few float32 roundings
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)


def test_active_params_count_the_held_experts():
    cfg = adapter.port_config(SMALL)
    total = cfg.param_count()
    routed = 2 * 4 * 3 * 64 * 32          # 2 MoE layers x 4 held experts
    assert total == sum(math.prod(s) for _, s, _ in R.layout(SMALL))
    assert cfg.active_param_count() == total - routed + routed * 3 // 16
    whole = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             n_held=None))
    routed = 2 * 16 * 3 * 64 * 32
    assert whole.active_param_count() == whole.param_count() - routed \
        + routed * 3 // 16


def test_moe_spans_filed_with_telemetry():
    p = _moe_params(0)
    tel = Telemetry()
    M.STATS.telemetry = tel
    try:
        M.moe_dropless(_share(p, 0, 4), torch.randn(8, 64), _moe_cfg(4, 0))
    finally:
        M.STATS.telemetry = None
    names = [s["name"] for s in tel.spans.timeline()]
    assert names == ["moe.route", "moe.experts"]


@pytest.mark.parametrize("capacity", [1.25, None])
def test_moe_ffn_refuses_a_share_or_no_capacity(capacity):
    cfg = dataclasses.replace(_moe_cfg(4, 0), capacity_factor=capacity)
    with pytest.raises(ValueError):
        M.moe_ffn(_share(_moe_params(), 0, 4), torch.randn(8, 64), cfg)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,sizes", [
    (2048, 2816, [1536, 0, 1700, 1, 1300, 1600, 1536, 1000]),   # w_in
    (1408, 2048, [1536, 0, 1700, 1, 1300, 1600, 1536, 1000]),   # w_out
    (96, 160, [0, 0, 130, 7]),                    # partial column tiles
])
def test_grouped_gemm_kernel_equals_plain_version(cuda, k, n, sizes):
    g = torch.Generator(device=cuda).manual_seed(k + n)
    off = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                       dtype=torch.int64, device=cuda)
    rows = int(off[-1]) + 37
    a = torch.randn(rows, k, generator=g, device=cuda).bfloat16()
    w = torch.randn(len(sizes), k, n, generator=g, device=cuda).bfloat16()
    dy = torch.randn(rows, n, generator=g, device=cuda).bfloat16()
    before, f0 = gg.grouped_gemm.launches, gg.flops()
    for mode, args in ((gg.FWD, (a, w)), (gg.DX, (dy, w)), (gg.DW, (a, dy))):
        got = gg.grouped_gemm(*args, off, mode)
        want = gg.grouped_gemm_ref(*[x.float() for x in args], off, mode)
        torch.cuda.synchronize()
        # bf16 results of float32 sums: one rounding, 2^-8 of the value
        torch.testing.assert_close(got.float(), want, rtol=8e-3,
                                   atol=8e-3 * float(want.abs().max()))
        if mode != gg.DW:
            assert not got[int(off[-1]):].any()
    assert gg.grouped_gemm.launches == before + 3
    assert gg.flops() - f0 == 3 * 2 * int(off[-1]) * k * n


@pytest.mark.gpu
def test_dropless_layer_on_the_card_syncs_nothing(cuda):
    cfg = M.MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2,
                      capacity_factor=None, n_held=8, norm_topk_prob=False,
                      aux_alpha=0.001)
    g = torch.Generator(device=cuda).manual_seed(0)
    p = {k: v.requires_grad_() for k, v in
         M.init_moe(g, 2048, cfg, device=cuda).items()}
    x = torch.randn(2, 2048, 2048, generator=g, device=cuda).bfloat16()
    x.requires_grad_()
    mask = torch.ones(2, 2048, dtype=torch.bool, device=cuda)
    mask[1, :100] = False
    M.STATS.reset()
    launches = gg.grouped_gemm.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = M.moe_dropless(p, x, cfg, mask)
        (out.float().square().mean() + aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert gg.grouped_gemm.launches == launches + 6
    counts = M.STATS.read()
    assert counts["dropped"] == 0 and counts["tokens"] == 4096
    # against the layer in float32 with the plain grouped product
    p32 = {k: v.detach().float() for k, v in p.items()}
    with torch.no_grad():
        want, _ = M.moe_dropless({k: v.cpu() for k, v in p32.items()},
                                 x.detach().float().cpu(),
                                 dataclasses.replace(cfg, aux_alpha=0.0))
    err = (out.detach().float().cpu() - want).norm() / want.norm()
    assert float(err) < 2e-2, float(err)


@pytest.mark.gpu
def test_dropless_layer_on_the_card_repeats_to_the_bit(cuda):
    """The combine and the token gather's backward sum each token's pairs
    in a fixed order, so two passes give the same bits."""
    cfg = M.MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2,
                      capacity_factor=None, n_held=8, norm_topk_prob=False,
                      aux_alpha=0.001)
    g = torch.Generator(device=cuda).manual_seed(1)
    p = M.init_moe(g, 2048, cfg, device=cuda)
    x0 = torch.randn(2, 2048, 2048, generator=g, device=cuda).bfloat16()
    runs = []
    for _ in range(2):
        x = x0.clone().requires_grad_()
        w = {k: v.clone().requires_grad_() for k, v in p.items()}
        out, aux = M.moe_dropless(w, x, cfg)
        (out.float().square().mean() + aux).backward()
        runs.append([out.detach(), x.grad] + [w[k].grad for k in sorted(w)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
