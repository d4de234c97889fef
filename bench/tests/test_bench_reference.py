"""The benchmark's frozen copies held against the port at test widths: the
traffic generator, the request schedule, the DLRM-UIH and DCN-v2 losses and
gradients, AdamW, and the FLOP count."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from bench.reference import weights as W
from bench.reference import adamw, dcn_v2, dlrm_uih, flops
from bench.reference.events import EventStream, StreamParams, day_requests
from bench.reference.precision import CONTROL, STATED, Precision
from bench.tests.cells import CONFIGS


def test_events_match_the_port():
    from repro_torch.core import events as ev

    port = ev.SyntheticEventStream(ev.StreamConfig(
        n_users=4, n_items=2000, days=5, events_per_user_day_mean=30,
        seed=2**31 + 5))
    mine = EventStream(StreamParams(n_users=4, n_items=2000, days=5,
                                    events_per_user_day_mean=30,
                                    seed=2**31 + 5))
    for uid in range(4):
        for day in range(5):
            a, b = port.day_events(uid, day), mine.day_events(uid, day)
            assert list(a) == list(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        t = 3 * ev.MS_PER_DAY + 12345
        a, b = port.history_until(uid, t), mine.history_until(uid, t)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_request_schedule_matches_the_port():
    from repro_torch.core import events as ev
    from repro_torch.core.simulation import ProductionSim, SimConfig

    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=6, n_items=500, days=3,
                               events_per_user_day_mean=10, seed=7),
        stripe_len=16, lookback_ms=2 * ev.MS_PER_DAY, seed=7))
    sim.ingest_day_events(0)
    sim._rng = np.random.default_rng(99)
    sim.issue_requests(0, capture_reference=False)
    got = [(e.user_id, e.request_ts, e.candidate["item_id"],
            e.labels["click"]) for e in sim.examples]
    want = [(r.user_id, r.request_ts, r.cand_item_id, r.click) for r in
            day_requests(np.random.default_rng(99), 0, 6, 500, 4)]
    assert got == want


def _dlrm_port(cfg, dtype):
    from repro_torch.models import recsys as R

    pc = R.DLRMUIHConfig(
        seq_len=cfg["seq_len"], d_seq=cfg["d_seq"],
        n_seq_layers=cfg["n_seq_layers"], n_heads=cfg["n_heads"],
        n_dense=cfg["n_dense"], n_sparse=cfg["n_sparse"],
        embed_dim=cfg["embed_dim"], item_vocab=cfg["item_vocab"],
        field_vocab=cfg["field_vocab"], top_mlp=tuple(cfg["top_mlp"]),
        compute_dtype=dtype, q_chunk=cfg["q_chunk"])
    return lambda p, b: R.dlrm_uih_loss(p, R.dlrm_uih_prep(b, pc), pc)


def _dcn_port(cfg, dtype):
    from repro_torch.models import recsys as R

    pc = R.DCNv2Config(n_dense=cfg["n_dense"], n_sparse=cfg["n_sparse"],
                       embed_dim=cfg["embed_dim"],
                       n_cross_layers=cfg["n_cross_layers"],
                       mlp=tuple(cfg["mlp"]), field_vocab=cfg["field_vocab"],
                       compute_dtype=dtype)
    return lambda p, b: R.dcn_v2_loss(p, R.dcn_v2_prep(b, pc), pc)


def _feed_batch(b, L, seed):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(0, L + 1, (b,), generator=g)
    mask = torch.arange(L)[None, :] >= (L - lens)[:, None]
    ids = torch.randint(0, 5000, (b, L), generator=g) * mask
    return {"uih_item_id": ids, "uih_action_type": (ids % 8).int(),
            "uih_mask": mask, "user_id": torch.randint(0, 999, (b,),
                                                       generator=g),
            "cand_item_id": torch.randint(0, 5000, (b,), generator=g),
            "label_click": (torch.rand(b, generator=g) < 0.3).float()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("fam", ["dlrm_uih", "dcn_v2"])
def test_loss_and_gradients_match_the_port(fam, dtype):
    cfg = dict(CONFIGS[fam])
    ref = {"dlrm_uih": dlrm_uih, "dcn_v2": dcn_v2}[fam]
    port = (_dlrm_port if fam == "dlrm_uih" else _dcn_port)(cfg, dtype)
    batch = _feed_batch(8, cfg.get("seq_len", 16), seed=3)
    grads = []
    for side in ("port", "ref"):
        _, tree = W.draw(ref.layout(cfg), 11, "cpu")
        params = W.as_parameters(tree)
        if side == "port":
            loss = port(params, batch)
        else:
            loss = ref.loss(params, ref.prep(batch, cfg), cfg,
                            Precision(dtype=dtype))
        loss.backward()
        grads.append((float(loss.detach()), [p.grad.clone() for p in
                                    W.leaves(params)]))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_layouts_match_the_port_tree():
    from repro_torch.configs import dcn_v2 as pd, dlrm_uih as pu
    from repro_torch.models import recsys as R
    from repro_torch.tree import tree_leaves

    for ref, cfg, port in ((dlrm_uih, CONFIGS["dlrm_uih"],
                            R.init_dlrm_uih(pu.SMOKE, 0, "cpu")),
                           (dcn_v2, CONFIGS["dcn_v2"],
                            R.init_dcn_v2(pd.SMOKE, 0, "cpu"))):
        cfg = dict(cfg)
        if ref is dlrm_uih:
            cfg.update(top_mlp=list(pu.SMOKE.top_mlp))
        shapes = [tuple(p.shape) for p in tree_leaves(port)]
        assert [s for _, s, _ in ref.layout(cfg)] == shapes


def test_adamw_matches_the_port():
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

    g = torch.Generator().manual_seed(0)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    p0 = [torch.randn(s, generator=g) for s in shapes]
    gs = [[torch.randn(s, generator=g) * 3 for s in shapes] for _ in range(3)]
    cfg = adamw.AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    port_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    a = {str(i): x.clone() for i, x in enumerate(p0)}
    state = adamw_init(a)
    b = [x.clone() for x in p0]
    m = [torch.zeros_like(x) for x in b]
    v = [torch.zeros_like(x) for x in b]
    for t in range(3):
        a, state, _ = adamw_update(a, {str(i): x.clone() for i, x in
                                       enumerate(gs[t])}, state, port_cfg)
        adamw.step(cfg, t + 1, b, [x.clone() for x in gs[t]], m, v)
    for i, x in enumerate(b):
        torch.testing.assert_close(a[str(i)], x, rtol=0, atol=0)


def test_control_differs_and_stated_is_identity():
    x = torch.randn(64, 64, dtype=torch.bfloat16)
    assert torch.equal(STATED.q(x), x)
    y = CONTROL.q(x)
    assert not torch.equal(y, x)
    assert (y.float() - x.float()).abs().max() <= 0.07 * x.float().abs().max()


def test_flops_count_the_products():
    cfg = dict(CONFIGS["dcn_v2"])
    d = cfg["n_sparse"] * cfg["embed_dim"] + cfg["n_dense"]
    macs = (cfg["n_cross_layers"] * d * d + d * 32 + 32 * 16
            + (16 + d) * 1)
    assert flops.per_example(dcn_v2, cfg, 8, 16) == pytest.approx(
        3 * 2 * macs)


def test_weights_from_the_seed_alone():
    lay = dcn_v2.layout(CONFIGS["dcn_v2"])
    a = W.leaves(W.draw(lay, 5, "cpu")[1])
    b = W.leaves(W.draw(lay, 5, "cpu")[1])
    c = W.leaves(W.draw(lay, 6, "cpu")[1])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[-1], c[-1]) or not torch.equal(a[2], c[2])
    names = W.leaf_names(lay)
    assert names == sorted(names)
    assert dataclasses.is_dataclass(STATED)


def test_change_norms_in_blocks_from_the_host(monkeypatch):
    from bench.reference import train

    monkeypatch.setattr(train, "CHUNK", 7)
    gen = torch.Generator().manual_seed(5)
    start = [torch.randn(5, 4, generator=gen), torch.randn(3, generator=gen)]
    now = [x + 0.1 * torch.randn(x.shape, generator=gen) for x in start]
    want = [float(torch.linalg.vector_norm(a - b)) for a, b in zip(now, start)]
    np.testing.assert_allclose(train.change_norms(now, start), want,
                               rtol=1e-6)


def test_worst_leaf_against_its_own_norm():
    from bench.reference.compare import gaps, worst

    want = {"loss": [1.0], "grad_norm": [100.0, 100.0, 0.5, 1e-6],
            "change_norm": [10.0, 10.0, 0.01, 5.0]}
    # a small leaf left unmoved: judged against its own norm, not the median
    got = dict(want, change_norm=[10.0, 10.0, 0.0, 0.0])
    g = gaps(got, want)
    assert g["change_gap"] == 1.0 and g["grad_gap"] == 0.0
    # the leaf whose gradient is nought to rounding is left out of both
    got = dict(want, grad_norm=[100.0, 100.0, 0.5, 1.0])
    assert gaps(got, want)["grad_gap"] == 0.0
    got = dict(want, grad_norm=[100.0, 101.0, 0.6, 1e-6])
    assert worst(got, want)["grad_gap"] == pytest.approx((0.2, 2))
