"""The port's LM/MoE/GNN zoo (``repro_torch.models.{transformer,moe,gnn}``,
the MLA and decode parts of ``layers``, the six configs and their
``interop``) against the JAX reference, float32 on the CPU at SMOKE.

Reference parameters go to the port through ``repro_torch.interop``;
inputs come from numpy seeds. Forward values (loss, prefill and decode
logits and caches) are held at ``rtol=1e-4, atol=1e-5``: both sides compute
in float32 and the slack covers the summation order of matrix products.
Gradients and the parameters after one AdamW step are held at ``rtol=1e-3,
atol=1e-5``: a gradient entry near zero carries the products' relative
error, and a first AdamW step moves each entry by about ``lr * g/(|g| +
eps)``. The MoE's dispatch is held exactly where it is integer.

The MoE archs' LM tests run at a capacity no (token, expert) pair can
exceed (``no_drops``): where pairs overflow, the reference's dispatch
clobbers a kept slot (a reference fault), and a prefill's drops are its own
(capacity is per call), so neither the parity nor decode's identity with
prefill would hold for reasons outside the port. Drops themselves are held
to a numpy oracle by ``test_moe_overflow_drops_only_the_overflowing_pairs``,
which also names the one token where the reference departs from it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import deepseek_v2_lite_16b as j_deepseek
from repro.configs import get_arch as j_get_arch
from repro.configs import granite_8b as j_granite
from repro.configs import meshgraphnet as j_mgn
from repro.configs import qwen3_4b as j_qwen4
from repro.configs import qwen3_8b as j_qwen8
from repro.configs import qwen3_moe_30b_a3b as j_qmoe
from repro.models import gnn as JG
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import adamw_init as j_adamw_init
from repro.train.optimizer import make_train_step as j_make_train_step
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import gnn as TG
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.train.optimizer import AdamWConfig as TAdamW
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.optimizer import make_train_step
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
LM = {"qwen3-8b": j_qwen8, "qwen3-4b": j_qwen4, "granite-8b": j_granite,
      "qwen3-moe-30b-a3b": j_qmoe, "deepseek-v2-lite-16b": j_deepseek}
B, S = 2, 32          # two loss and attention chunks of 16 at SMOKE


def no_drops(cfg):
    """``cfg`` with a capacity of at least T per expert (every pair kept)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def lm_configs(arch):
    """The reference's and the port's SMOKE configs of ``arch``, no drops."""
    return no_drops(LM[arch].SMOKE), no_drops(get_arch(arch).smoke)


def _close(got, want, **tol):
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


_TREES = {}


def reference_tree(arch):
    """The reference's SMOKE parameters for ``arch`` as numpy (drawn once)."""
    if arch not in _TREES:
        spec = j_get_arch(arch)
        init = JG.init if spec.family == "gnn" else JT.init
        _TREES[arch] = jax.tree.map(np.asarray,
                                    init(jax.random.PRNGKey(0), spec.smoke))
    return _TREES[arch]


def port_params(arch):
    cfg = get_arch(arch).smoke
    to_port = (interop.meshgraphnet_params_from_numpy if arch == "meshgraphnet"
               else interop.transformer_params_from_numpy)
    return to_port(reference_tree(arch), cfg, "cpu")


def tokens(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the LMs: loss, gradients, one AdamW step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(LM))
def test_lm_loss_and_gradients_match_reference(arch):
    jcfg, tcfg = lm_configs(arch)
    tok, tgt = tokens(jcfg, 0), tokens(jcfg, 1)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jnp.asarray(tok), jnp.asarray(tgt), jcfg)))(
            reference_tree(arch))
    params = port_params(arch)
    loss = TT.loss_fn(params, torch.from_numpy(tok), torch.from_numpy(tgt),
                      tcfg)
    _close(loss, want)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    jl = jax.tree.leaves(jgrads)
    assert len(grads) == len(jl)
    for g, j in zip(grads, jl):
        _close(g, j, **GRAD_TOL)


@pytest.mark.parametrize("arch", list(LM))
def test_lm_adamw_step_matches_reference(arch):
    jcfg, tcfg = lm_configs(arch)
    tok, tgt = tokens(jcfg, 2), tokens(jcfg, 3)
    tree = reference_tree(arch)
    jstep = j_make_train_step(
        lambda p, b: JT.loss_fn(p, b["tokens"], b["targets"], jcfg), JAdamW())
    jp, jo, jm = jax.jit(jstep)(tree, j_adamw_init(tree),
                                {"tokens": jnp.asarray(tok),
                                 "targets": jnp.asarray(tgt)})
    params = port_params(arch)
    step = make_train_step(
        lambda p, b: TT.loss_fn(p, b["tokens"], b["targets"], tcfg), TAdamW())
    tp, to, tm = step(params, adamw_init(params),
                      {"tokens": torch.from_numpy(tok),
                       "targets": torch.from_numpy(tgt)})
    for k in ("loss", "grad_norm", "lr"):
        _close(tm[k], jm[k])
    assert int(to.step) == int(jo.step) == 1
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a, b, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the LMs: serving
# ---------------------------------------------------------------------------

def _cache_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k])


@pytest.mark.parametrize("arch", list(LM))
def test_lm_prefill_matches_reference(arch):
    jcfg, tcfg = lm_configs(arch)
    tok = tokens(jcfg, 4)
    jlogits, jcache = jax.jit(lambda p, t: JT.prefill(p, t, jcfg))(
        reference_tree(arch), jnp.asarray(tok))
    with torch.no_grad():
        logits, cache = TT.prefill(port_params(arch), torch.from_numpy(tok),
                                   tcfg)
    assert tuple(logits.shape) == (B, tcfg.vocab)
    _close(logits, jlogits)
    _cache_close(cache, jcache)


def _padded(cache, max_len):
    """A (L, B, S, ...) cache zero-padded along S to ``max_len``."""
    out = {}
    for k, c in cache.items():
        out[k] = c.new_zeros((c.shape[0], c.shape[1], max_len, *c.shape[3:]))
        out[k][:, :, :c.shape[2]] = c
    return out


@pytest.mark.parametrize("arch", list(LM))
def test_lm_decode_step_matches_reference(arch):
    """One decode step into a cache of S + 4 positions, one row writing at
    S and one at S + 2, against the reference's functional update."""
    jcfg, tcfg = lm_configs(arch)
    tok = tokens(jcfg, 5)
    nxt = tokens(jcfg, 6, b=1, s=B)[0]
    position = np.array([S, S + 2], np.int32)
    tree = reference_tree(arch)
    _, jcache = jax.jit(lambda p, t: JT.prefill(p, t, jcfg))(
        tree, jnp.asarray(tok))
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 4)) + ((0, 0),) * (v.ndim - 3))
              for k, v in jcache.items()}
    jlogits, jnew = jax.jit(lambda p, c, t, q: JT.decode_step(p, c, t, q, jcfg))(
        tree, jcache, jnp.asarray(nxt), jnp.asarray(position))
    params = port_params(arch)
    with torch.no_grad():
        _, cache = TT.prefill(params, torch.from_numpy(tok), tcfg)
        cache = _padded(cache, S + 4)
        logits, new = TT.decode_step(params, cache, torch.from_numpy(nxt),
                                     torch.from_numpy(position), tcfg)
    assert new is cache                      # written in place
    _close(logits, jlogits)
    _cache_close(new, jnew)


@pytest.mark.parametrize("arch", list(LM))
def test_lm_decode_after_prefill_equals_prefill_of_the_whole(arch):
    """Prefill S tokens, decode 4 more greedily: the last step's logits are
    prefill's over the S + 4 tokens."""
    tcfg = lm_configs(arch)[1]
    tok = torch.from_numpy(tokens(tcfg, 7))
    params = port_params(arch)
    with torch.no_grad():
        logits, cache = TT.prefill(params, tok, tcfg)
        cache = _padded(cache, S + 4)
        seq = tok
        for i in range(4):
            nxt = logits.argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            logits, cache = TT.decode_step(
                params, cache, nxt, torch.full((B,), S + i), tcfg)
        # the last step read token S+3 at position S+3
        want, _ = TT.prefill(params, seq, tcfg)
    _close(logits, want)


def test_decode_clamps_an_out_of_range_position_into_the_cache():
    """``dynamic_update_slice`` clamps the start: a position past the end
    writes the last slot, as the reference."""
    arch = "qwen3-4b"
    jcfg, tcfg = lm_configs(arch)
    tree = reference_tree(arch)
    cache = {k: np.asarray(v) for k, v in
             JT.init_kv_cache(jcfg, 2, 8, jnp.float32).items()}
    nxt, position = np.array([3, 5], np.int32), np.array([8, 11], np.int32)
    jlogits, jnew = JT.decode_step(tree, {k: jnp.asarray(v) for k, v in
                                          cache.items()},
                                   jnp.asarray(nxt), jnp.asarray(position),
                                   jcfg)
    with torch.no_grad():
        logits, new = TT.decode_step(
            port_params(arch), {k: torch.from_numpy(v.copy())
                                for k, v in cache.items()},
            torch.from_numpy(nxt), torch.from_numpy(position), tcfg)
    _close(logits, jlogits)
    _cache_close(new, jnew)
    assert bool(new["k"][:, :, -1].abs().sum() > 0)


def test_mla_decode_equals_train_at_the_last_position():
    cfg = get_arch("deepseek-v2-lite-16b").smoke.mla_cfg
    gen = torch.Generator().manual_seed(0)
    p = TL.init_mla(gen, cfg, device="cpu")
    x = torch.randn((B, 12, cfg.d_model), generator=gen)
    pos = torch.arange(12)[None, :].expand(B, 12)
    with torch.no_grad():
        want = TL.mla_attention_train(p, x, pos, cfg)[:, -1:]
        c_kv, k_pe = TL.mla_new_cache_entries(p, x, pos, cfg)
        got = TL.mla_attention_decode(p, x[:, -1:], pos[:, -1:], c_kv, k_pe,
                                      torch.ones((B, 12), dtype=torch.bool),
                                      cfg)
    _close(got, want)
    # and the reference's absorbed form agrees on the same inputs
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    jcfg = JL.MLAConfig(**_shared_fields(cfg, JL.MLAConfig))
    jwant = JL.mla_attention_decode(
        jp, jnp.asarray(x[:, -1:].numpy()), jnp.asarray(pos[:, -1:].numpy()),
        jnp.asarray(c_kv.numpy()), jnp.asarray(k_pe.numpy()),
        jnp.ones((B, 12), bool), jcfg)
    _close(got, jwant)


# ---------------------------------------------------------------------------
# the MoE
# ---------------------------------------------------------------------------

MOE_CFG = j_qmoe.SMOKE.moe          # E=8, top-2, d_ff 32 (d_model 64)


def _moe_params(seed, skew=0.0, n_shared=0):
    """Reference MoE parameters (numpy) for the SMOKE MoE shape; ``skew``
    adds to expert 0's router column so it fills first."""
    cfg = dataclasses.replace(MOE_CFG, n_shared=n_shared)
    tree = jax.tree.map(np.asarray,
                        JM.init_moe(jax.random.PRNGKey(seed), 64, cfg))
    tree["router"] = tree["router"].copy()
    tree["router"][:, 0] += skew
    return tree, cfg


def _port_moe_cfg(jcfg):
    return TM.MoEConfig(**{**dataclasses.asdict(jcfg),
                           "router_dtype": torch.float32})


def _tokens_x(seed, t):
    return np.random.default_rng(seed).standard_normal((t, 64)).astype(
        np.float32)


def _oracle_tables(idx, gate, n_experts, cap):
    """The dispatch tables by their definition: per expert, its pairs in
    token order (then k order); the first ``cap`` kept."""
    t, k = idx.shape
    disp_t = np.full((n_experts, cap), t, np.int64)
    disp_g = np.zeros((n_experts, cap), np.float32)
    fill = np.zeros(n_experts, np.int64)
    for tok in range(t):
        for j in range(k):
            e = idx[tok, j]
            if fill[e] < cap:
                disp_t[e, fill[e]] = tok
                disp_g[e, fill[e]] = gate[tok, j]
            fill[e] += 1
    return disp_t, disp_g, fill


def _reference_routing(tree, x, cfg):
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(tree["router"]), -1)
    gate, idx = jax.lax.top_k(probs, cfg.top_k)
    gate = gate / jnp.sum(gate, axis=-1, keepdims=True)
    return np.asarray(gate), np.asarray(idx)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_routing_and_dispatch_tables_match_exactly(seed):
    tree, jcfg = _moe_params(seed)
    jcfg = dataclasses.replace(jcfg, capacity_factor=2.0)   # no pair drops
    cfg = _port_moe_cfg(jcfg)
    x = _tokens_x(seed, 24)
    jgate, jidx = _reference_routing(tree, x, jcfg)
    gate, idx = TM.route(torch.from_numpy(x), torch.from_numpy(tree["router"]),
                         cfg)
    assert np.array_equal(idx.numpy(), jidx)
    _close(gate, jgate)
    cap = TM._capacity(24, cfg)
    assert cap == JM._capacity(24, jcfg)
    want_t, want_g, fill = _oracle_tables(jidx, jgate, cfg.n_experts, cap)
    assert fill.max() <= cap                         # nothing overflows
    disp_t, disp_g = TM.dispatch(idx, gate, cfg, cap, cfg.n_experts)
    assert np.array_equal(disp_t.numpy(), want_t)
    _close(disp_g, want_g)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_ffn_equals_moe_ref_at_ample_capacity(n_shared):
    tree, jcfg = _moe_params(3, n_shared=n_shared)
    jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
    cfg = _port_moe_cfg(jcfg)
    x = _tokens_x(3, 40).reshape(4, 10, 64)
    params = {k: torch.tensor(v) for k, v in tree.items()}
    got = TM.moe_ffn(params, torch.from_numpy(x), cfg)
    _close(got, TM.moe_ref(params, torch.from_numpy(x), cfg))
    _close(got, JM.moe_ref(tree, jnp.asarray(x), jcfg))
    _close(got, JM.moe_ffn(tree, jnp.asarray(x), jcfg))


def _oracle_moe(tree, x, idx, gate, cap):
    """The MoE output with capacity drops, in numpy: each expert's first
    ``cap`` pairs."""
    disp_t, disp_g, _ = _oracle_tables(idx, gate, idx.max() + 1, cap)
    out = np.zeros_like(x, dtype=np.float64)
    f = tree["w_out"].shape[1]
    for e in range(disp_t.shape[0]):
        for slot in range(cap):
            tok = disp_t[e, slot]
            if tok == x.shape[0]:
                continue
            h = x[tok].astype(np.float64) @ tree["w_in"][e]
            g, u = h[:f], h[f:]
            act = g / (1 + np.exp(-g)) * u
            out[tok] += disp_g[e, slot] * (act @ tree["w_out"][e])
    return out


@pytest.mark.parametrize("t", [64, 256])
def test_moe_overflow_drops_only_the_overflowing_pairs(t):
    """Expert 0 overflows under a skewed router. The port keeps each
    expert's first ``cap`` pairs and drops the rest (the numpy oracle); the
    reference agrees on every token but one: the token in expert 0's last
    slot ``(0, cap-1)``, whose expert-0 output the reference's dropped
    pairs overwrite (a reference fault)."""
    tree, jcfg = _moe_params(4, skew=0.3)
    cfg = _port_moe_cfg(jcfg)
    x = _tokens_x(4, t)
    jgate, jidx = _reference_routing(tree, x, jcfg)
    cap = TM._capacity(t, cfg)
    disp_t, _, fill = _oracle_tables(jidx, jgate, cfg.n_experts, cap)
    assert fill[0] > cap                              # expert 0 overflows
    clobbered = int(disp_t[0, cap - 1])               # its last kept token
    params = {k: torch.tensor(v) for k, v in tree.items()}
    got = TM.moe_ffn(params, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, _oracle_moe(tree, x, jidx, jgate, cap),
                               **TOL)
    want = np.asarray(JM.moe_ffn(tree, jnp.asarray(x), jcfg))
    differ = np.flatnonzero(~np.isclose(got, want, **TOL).all(axis=1))
    assert differ.tolist() == [clobbered]


def test_moe_on_the_one_rank_mesh_and_refusing_more_ranks():
    """Both layouts on the one-rank mesh equal the mesh-free MoE; on the
    16x16 fake mesh neither refuses any more: rank 0's blocks (16 experts,
    one a model rank) run its rank-local program on fake tensors and give
    its tokens' rows (values on many ranks: tests/test_torch_zoo_mesh.py)."""
    tree, jcfg = _moe_params(5, n_shared=1)
    cfg = _port_moe_cfg(jcfg)
    x = torch.from_numpy(_tokens_x(5, 16))
    params = {k: torch.tensor(v) for k, v in tree.items()}
    plain = TM.moe_ffn(params, x, cfg)
    mesh = make_test_mesh(1, "cpu")
    try:
        for mode in ("fsdp", "2d"):
            got = TM.moe_ffn(params, x, dataclasses.replace(cfg, ep_mode=mode),
                             mesh=mesh)
            _close(got, plain)
        big = make_production_mesh()
        d, f, n = 64, cfg.d_ff, 16
        blocks = {"fsdp": {"w_in": (1, d, 2 * f // n), "w_out": (1, f, d // n)},
                  "2d": {"w_in": (1, d // n, 2 * f), "w_out": (1, f // n, d)}}
        with FakeTensorMode():
            for mode, shapes in blocks.items():
                local = {"router": torch.empty(d, n),
                         "shared_w_in": torch.empty(d, 2 * f // n),
                         "shared_w_out": torch.empty(f // n, d),
                         **{k: torch.empty(v) for k, v in shapes.items()}}
                wide = dataclasses.replace(cfg, n_experts=n, ep_mode=mode)
                out = TM.moe_ffn(local, torch.empty(16, d), wide, mesh=big)
                assert tuple(out.shape) == (16, d)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# MeshGraphNet
# ---------------------------------------------------------------------------

def _graph(seed, n=20, e=60, cfg=j_mgn.SMOKE):
    rng = np.random.default_rng(seed)
    return {"node_feats": rng.standard_normal((n, cfg.d_node_in)).astype(
                np.float32),
            "edge_feats": rng.standard_normal((e, cfg.d_edge_in)).astype(
                np.float32),
            "senders": rng.integers(0, n, e).astype(np.int32),
            "receivers": rng.integers(0, n, e).astype(np.int32),
            "targets": rng.standard_normal((n, cfg.d_out)).astype(np.float32),
            "edge_mask": rng.random(e) < 0.8,
            "node_mask": (rng.random(n) < 0.7).astype(np.float32)}


@pytest.mark.parametrize("masked", [False, True])
def test_meshgraphnet_forward_and_loss_match_reference(masked):
    g = _graph(0)
    jcfg, tcfg = j_mgn.SMOKE, get_arch("meshgraphnet").smoke
    tree = reference_tree("meshgraphnet")
    j = {k: jnp.asarray(v) for k, v in g.items()}
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    em = ("edge_mask",) if masked else ()
    jargs = [j[k] for k in ("node_feats", "edge_feats", "senders",
                            "receivers")]
    targs = [t[k] for k in ("node_feats", "edge_feats", "senders",
                            "receivers")]
    want = JG.forward(tree, *jargs, jcfg, *(j[k] for k in em))
    params = port_params("meshgraphnet")
    _close(TG.forward(params, *targs, tcfg, *(t[k] for k in em)), want)
    kw = dict(node_mask=j["node_mask"], edge_mask=j["edge_mask"]) \
        if masked else {}
    tkw = dict(node_mask=t["node_mask"], edge_mask=t["edge_mask"]) \
        if masked else {}
    want, jgrads = jax.value_and_grad(
        lambda p: JG.loss_fn(p, *jargs, j["targets"], jcfg, **kw))(tree)
    loss = TG.loss_fn(params, *targs, t["targets"], tcfg, **tkw)
    _close(loss, want)
    for a, b in zip(torch.autograd.grad(loss, tree_leaves(params)),
                    jax.tree.leaves(jgrads)):
        _close(a, b, **GRAD_TOL)


def test_meshgraphnet_masked_edges_keep_finite_gradients_at_full_depth():
    """At FULL depth (15 blocks, SMOKE widths) a masked edge's zero state
    sends the reference's gradient through 15 zero-variance ``_ln``
    backwards (1000x each) into NaN (a reference fault); the port masks
    the state after each ``_ln``: the same loss, finite gradients."""
    jcfg = dataclasses.replace(j_mgn.SMOKE, n_layers=15)
    tcfg = dataclasses.replace(get_arch("meshgraphnet").smoke, n_layers=15)
    tree = jax.tree.map(np.asarray, JG.init(jax.random.PRNGKey(1), jcfg))
    g = _graph(1)
    keys = ("node_feats", "edge_feats", "senders", "receivers", "targets")
    want, jgrads = jax.value_and_grad(lambda p: JG.loss_fn(
        p, *(jnp.asarray(g[k]) for k in keys), jcfg,
        edge_mask=jnp.asarray(g["edge_mask"])))(tree)
    assert not all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree.leaves(jgrads))
    params = interop.meshgraphnet_params_from_numpy(tree, tcfg, "cpu")
    loss = TG.loss_fn(params, *(torch.from_numpy(g[k]) for k in keys), tcfg,
                      edge_mask=torch.from_numpy(g["edge_mask"]))
    _close(loss, want)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert all(bool(torch.isfinite(x).all()) for x in grads)


def test_sample_subgraph_is_byte_equal_to_the_reference():
    rng = np.random.default_rng(0)
    n, e = 500, 4000
    senders, receivers = rng.integers(0, n, e), rng.integers(0, n, e)
    receivers[:30] = 7                          # one node with many in-edges
    g_j, g_t = (JG.CSRGraph(n, senders, receivers),
                TG.CSRGraph(n, senders, receivers))
    assert np.array_equal(g_j.indptr, g_t.indptr)
    assert np.array_equal(g_j.src_sorted, g_t.src_sorted)
    seeds = rng.choice(n, size=16, replace=False)
    for fanouts in ((3, 2), (15, 10)):
        want = JG.sample_subgraph(g_j, seeds, fanouts,
                                  np.random.default_rng(1))
        got = TG.sample_subgraph(g_t, seeds, fanouts,
                                 np.random.default_rng(1))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# configs and interop
# ---------------------------------------------------------------------------

def _shared_fields(cfg, ref_cls) -> dict:
    """The port config's fields that the reference's class has; the port's
    others (features the reference lacks) must sit at their defaults."""
    names = {f.name for f in dataclasses.fields(ref_cls)}
    for f in dataclasses.fields(cfg):
        if f.name not in names:
            assert getattr(cfg, f.name) == f.default, f.name
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k in names}


def _fields(cfg, ref=None):
    """``cfg``'s fields as comparable values; with ``ref`` (the reference's
    config) only the fields the reference has, the port's others required
    at their defaults (``_shared_fields``)."""
    out = {}
    names = None if ref is None else set(_shared_fields(cfg, type(ref)))
    for f in dataclasses.fields(cfg):
        if names is not None and f.name not in names:
            continue
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v, None if ref is None else getattr(ref, f.name))
        elif hasattr(v, "dtype") or isinstance(v, (torch.dtype, type)):
            v = str(jnp.dtype(v) if not isinstance(v, torch.dtype)
                    else v).replace("torch.", "")
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", [*LM, "meshgraphnet"])
def test_configs_equal_the_reference_field_for_field(arch):
    t, j = get_arch(arch), j_get_arch(arch)
    assert (t.arch_id, t.family, t.notes) == (j.arch_id, j.family, j.notes)
    assert t.shapes == j.shapes
    for which in ("full", "smoke"):
        tc, jc = getattr(t, which), getattr(j, which)
        assert _fields(tc, jc) == _fields(jc), which
    assert t.full.param_count() == j.full.param_count()
    if t.family == "lm":
        assert t.full.active_param_count() == j.full.active_param_count()
        assert t.full.attn_cfg.qk_norm == j.full.attn_cfg.qk_norm
        assert _shared_fields(t.full.mla_cfg, type(j.full.mla_cfg)).items() \
            <= dataclasses.asdict(j.full.mla_cfg).items()


@pytest.mark.parametrize("case", ["dense-for-moe", "gqa-for-mla",
                                  "layers", "recsys", "gnn-width"])
def test_interop_raises_on_a_foreign_tree(case):
    if case == "gnn-width":
        cfg = dataclasses.replace(get_arch("meshgraphnet").smoke, d_hidden=8)
        with pytest.raises(ValueError):
            interop.meshgraphnet_params_from_numpy(
                reference_tree("meshgraphnet"), cfg, "cpu")
        return
    tree, cfg = {
        "dense-for-moe": (reference_tree("qwen3-4b"),
                          get_arch("qwen3-moe-30b-a3b").smoke),
        "gqa-for-mla": (reference_tree("qwen3-moe-30b-a3b"),
                        get_arch("deepseek-v2-lite-16b").smoke),
        "layers": (reference_tree("granite-8b"), dataclasses.replace(
            get_arch("granite-8b").smoke, n_layers=3)),
        "recsys": (reference_tree("meshgraphnet"),
                   get_arch("qwen3-8b").smoke),
    }[case]
    with pytest.raises(ValueError):
        interop.transformer_params_from_numpy(tree, cfg, "cpu")
