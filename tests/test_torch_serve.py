"""The port's two-tower model and serving tier against the JAX reference.

The same parameters (built once by the reference, carried over as numpy)
and the same sim seed go through both packages. Towers, loss and scores
agree in float32 within ``1e-5`` (another matmul and reduction order). The
server returns the reference's item ids exactly and its scores within
``1e-5``; ties in the top-k come out in ``jax.lax.top_k``'s order, the lower
index first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sim
from repro.models import recsys as JR
from repro.serve import RetrievalServer as JServer
from repro.serve import ServeConfig as JServeConfig
from repro.serve.index import CandidateIndex as JIndex
from repro_torch.configs import two_tower_retrieval as t_cfgs
from repro_torch.core import events as tev
from repro_torch.core.simulation import ProductionSim, SimConfig
from repro_torch.interop import two_tower_params_from_numpy
from repro_torch.models import recsys as TR
from repro_torch.serve import RetrievalServer, ServeConfig
from repro_torch.serve.index import CandidateIndex, topk_lower_index_first

# tests/test_serve.py's configuration
J_CFG = JR.TwoTowerConfig(
    name="test-serve", embed_dim=8, tower_mlp=(16, 8), item_vocab=1_500,
    user_vocab=64, uih_len=16, compute_dtype=jnp.float32)
T_CFG = TR.TwoTowerConfig(
    name="test-serve", embed_dim=8, tower_mlp=(16, 8), item_vocab=1_500,
    user_vocab=64, uih_len=16, compute_dtype=torch.float32)
TOP_K = 5


@pytest.fixture(scope="module")
def params():
    tree = jax.tree.map(np.asarray, JR.init_two_tower(jax.random.PRNGKey(0),
                                                      J_CFG))
    return tree, two_tower_params_from_numpy(tree, T_CFG, "cpu")


def _batch(rng, b, cfg):
    lens = rng.integers(0, cfg.uih_len + 1, b)
    return {
        "user_id": rng.integers(0, cfg.user_vocab, b).astype(np.int32),
        "uih_item_id": rng.integers(0, cfg.item_vocab,
                                    (b, cfg.uih_len)).astype(np.int32),
        "uih_mask": np.arange(cfg.uih_len)[None, :] >= (cfg.uih_len
                                                        - lens)[:, None],
        "cand_item_id": rng.integers(0, cfg.item_vocab, b).astype(np.int32),
    }


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_towers_match_reference(params):
    tree, tp = params
    jp = jax.tree.map(jnp.asarray, tree)
    b = _batch(np.random.default_rng(1), 7, J_CFG)
    _close(TR.two_tower_user(tp, *[_t(b)[k] for k in
                                   ("user_id", "uih_item_id", "uih_mask")],
                             T_CFG),
           JR.two_tower_user(jp, *[_j(b)[k] for k in
                                   ("user_id", "uih_item_id", "uih_mask")],
                             J_CFG))
    _close(TR.two_tower_item(tp, _t(b)["cand_item_id"], T_CFG),
           JR.two_tower_item(jp, _j(b)["cand_item_id"], J_CFG))


def test_loss_and_candidate_scores_match_reference(params):
    tree, tp = params
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(2)
    b = _batch(rng, 6, J_CFG)
    log_q = rng.standard_normal(6).astype(np.float32)
    _close(TR.two_tower_loss(tp, _t(b), T_CFG),
           JR.two_tower_loss(jp, _j(b), J_CFG))
    _close(TR.two_tower_loss(tp, _t(b), T_CFG, torch.from_numpy(log_q)),
           JR.two_tower_loss(jp, _j(b), J_CFG, jnp.asarray(log_q)))
    one = {k: v[:1] for k, v in b.items()}
    cands = rng.integers(0, J_CFG.item_vocab, 40).astype(np.int32)
    _close(TR.two_tower_score_candidates(tp, _t(one), torch.from_numpy(cands),
                                         T_CFG),
           JR.two_tower_score_candidates(jp, _j(one), jnp.asarray(cands),
                                         J_CFG))


def test_loss_backward_reaches_every_parameter(params):
    _, tp = params
    b = _batch(np.random.default_rng(3), 5, T_CFG)
    TR.two_tower_loss(tp, _t(b), T_CFG).backward()
    grads = [p.grad for p in tp.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    for p in tp.parameters():
        p.grad = None


def test_interop_rejects_a_tree_that_does_not_fit(params):
    tree, _ = params
    with pytest.raises(ValueError, match="two-tower"):
        two_tower_params_from_numpy({"item_table": tree["item_table"]},
                                    T_CFG, "cpu")
    with pytest.raises(ValueError, match="item_table"):
        two_tower_params_from_numpy(tree, t_cfgs.SMOKE, "cpu")


def test_init_two_tower_matches_the_config():
    cfg = t_cfgs.SMOKE
    p = TR.init_two_tower(cfg, seed=0, device="cpu")
    assert sum(x.numel() for x in p.parameters()) == cfg.param_count()
    assert p["item_table"].shape == (cfg.item_vocab, cfg.embed_dim)
    assert p["user_mlp"]["w0"].shape == (2 * cfg.embed_dim, cfg.tower_mlp[0])
    again = TR.init_two_tower(cfg, seed=0, device="cpu")
    assert torch.equal(p["user_table"], again["user_table"])


@pytest.mark.parametrize("k", [1, 7, 40])
def test_topk_breaks_ties_as_lax_top_k(k):
    """Scores on a coarse grid, signed zeros included: ties everywhere."""
    rng = np.random.default_rng(k)
    s = (rng.integers(-4, 5, (6, 300)) / 4).astype(np.float32)
    s[0, ::3] = -0.0
    s[1] = 0.5                                   # one value across the row
    got_v, got_i = topk_lower_index_first(torch.from_numpy(s), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_v.numpy().tobytes() == np.asarray(want_v).tobytes()


def test_candidate_index_top_k_ties_match_reference(params):
    """An index whose rows repeat a few integer vectors: every score is
    exact and most of them tie."""
    tree, tp = params
    rng = np.random.default_rng(4)
    rows = rng.integers(-2, 3, (6, T_CFG.embed_dim)).astype(np.float32)
    emb = rows[rng.integers(0, len(rows), T_CFG.item_vocab)]
    user = rng.integers(-2, 3, (8, T_CFG.embed_dim)).astype(np.float32)
    port = CandidateIndex(T_CFG, device="cpu")
    port.refresh(tp)
    ref = JIndex(J_CFG)
    ref.refresh(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(port.embeddings(), ref.embeddings(),
                               rtol=1e-5, atol=1e-6)
    port._emb, ref._emb = torch.from_numpy(emb), jnp.asarray(emb)
    got_ids, got_s = port.top_k(user, 25)
    want_ids, want_s = ref.top_k(user, 25)
    assert len(set(got_s[0])) < 25                 # ties inside the top-k
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_s, want_s)
    assert port.stats.queries == 1 and port.stats.scored_rows == 8


def _sims(seed):
    """The reference's tests/conftest.py sim and the port's, same knobs."""
    ref = make_sim(users=6, days=2, seed=seed, capture_reference=False)
    port = ProductionSim(SimConfig(
        stream=tev.StreamConfig(n_users=6, n_items=1_500, days=4,
                                events_per_user_day_mean=25.0, seed=seed),
        stripe_len=16, requests_per_user_day=3, seed=seed))
    port.run_days(2, capture_reference=False)
    return ref, port


def _mix(sim, n=64):
    now = max(e.request_ts for e in sim.examples)
    seq = [e.user_id for e in sim.examples]
    return now, (seq * (n // len(seq) + 1))[:n]


def _issue(server, now, users):
    pendings = [server.submit(u, now, k=TOP_K) for u in users]
    return [p.result(timeout=30.0) for p in pendings]


def _no_leaks(server, sim):
    assert server.stats.failed_requests == 0
    assert server.materializer.stats.stale_failures == 0
    assert sim.immutable.leased_generations() == {}


def test_server_matches_reference_server(params):
    tree, tp = params
    j_sim, t_sim = _sims(seed=3)
    now, users = _mix(t_sim)
    assert (now, users) == _mix(j_sim)
    kw = dict(max_batch=8, max_delay_s=0.001)
    jsrv = JServer.from_sim(j_sim, jax.tree.map(jnp.asarray, tree), J_CFG,
                            cfg=JServeConfig(lookback_ms=j_sim.cfg.lookback_ms,
                                             **kw))
    want = _issue(jsrv, now, users)
    jsrv.close()
    tsrv = RetrievalServer.from_sim(
        t_sim, tp, T_CFG, device="cpu",
        cfg=ServeConfig(lookback_ms=t_sim.cfg.lookback_ms, **kw))
    got = _issue(tsrv, now, users)
    tsrv.close()
    _no_leaks(tsrv, t_sim)
    assert tsrv.stats.requests == len(users)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.user_id, g.generation, g.index_version) == (
            w.user_id, w.generation, w.index_version)
        np.testing.assert_array_equal(g.item_ids, w.item_ids,
                                      err_msg=f"request {i}")
        assert g.scores.dtype == np.float32
        np.testing.assert_allclose(g.scores, w.scores, rtol=1e-5, atol=1e-5,
                                   err_msg=f"request {i}")


def test_cache_on_byte_identical_to_cache_off(params):
    _, tp = params
    _, sim = _sims(seed=4)
    now, users = _mix(sim)

    def server(**kw):
        return RetrievalServer.from_sim(
            sim, tp, T_CFG, device="cpu", cfg=ServeConfig(
                lookback_ms=sim.cfg.lookback_ms, max_batch=8,
                max_delay_s=0.001, **kw))

    off = server(cache_capacity=0, window_cache_size=0)
    ref = _issue(off, now, users)
    off.close()
    _no_leaks(off, sim)
    assert off.stats.cold_requests == len(users)
    on = server()
    got = _issue(on, now, users)
    got2 = _issue(on, now, users)
    on.close()
    _no_leaks(on, sim)
    for wave in (got, got2):
        for a, b in zip(ref, wave):
            assert a.item_ids.tobytes() == b.item_ids.tobytes()
            assert a.scores.tobytes() == b.scores.tobytes()
    assert all(r.cached for r in got2)
    assert on.stats.cold_requests < len(users)
    assert len(on.spans) == on.stats.batches
    with pytest.raises(RuntimeError, match="closed"):
        on.submit(users[0], now)
