"""The port's layers and DLRM-UIH against the JAX reference, float32 on the CPU.

Reference parameters go to the port through ``repro_torch.interop`` (torch
and jax draw different numbers from one seed); inputs come from numpy seeds.
Tolerance ``rtol=1e-4, atol=1e-5``: both sides compute in float32, and the
slack covers the summation order of float32 matrix products.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_uih as j_cfgs
from repro.models import layers as JL
from repro.models import recsys as JR
from repro_torch.configs import dlrm_uih as t_cfgs
from repro_torch.interop import dlrm_uih_params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import recsys as TR
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_configs_mirror_the_reference():
    for name in ("FULL", "SMOKE"):
        j, t = getattr(j_cfgs, name), getattr(t_cfgs, name)
        for f in dataclasses.fields(t):
            if f.name != "compute_dtype":
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
    assert t_cfgs.FULL.compute_dtype == torch.bfloat16
    assert t_cfgs.SMOKE.compute_dtype == torch.float32


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    pos = np.tile(np.arange(5), (2, 1))
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


@pytest.mark.parametrize("q_chunk", [3, 16])
def test_masked_chunked_attention_with_an_all_masked_row(q_chunk):
    """Right-aligned rows: early query positions see no valid key at all. The
    finite -1e30 mask keeps those rows finite (uniform attention), as in the
    reference; an all-masked batch row is included."""
    rng = np.random.default_rng(1)
    b, s, d, h = 3, 10, 16, 2
    cfg_j = JL.AttnConfig(d_model=d, n_heads=h, n_kv_heads=h, head_dim=d // h,
                          rope_theta=1e4, q_chunk=q_chunk)
    cfg_t = TL.AttnConfig(d_model=d, n_heads=h, n_kv_heads=h,
                          head_dim=d // h, rope_theta=1e4, q_chunk=q_chunk)
    params = jax.tree.map(np.asarray, JL.init_gqa(jax.random.PRNGKey(0),
                                                  cfg_j))
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    lens = np.array([4, 0, 10])
    mask = np.arange(s)[None, :] >= (s - lens)[:, None]
    pos = np.tile(np.arange(s), (b, 1))
    got = TL.gqa_attention({k: torch.tensor(v) for k, v in params.items()},
                           torch.from_numpy(x), torch.from_numpy(pos), cfg_t,
                           causal=True, kv_mask=torch.from_numpy(mask))
    want = JL.gqa_attention(params, jnp.asarray(x), jnp.asarray(pos), cfg_j,
                            causal=True, kv_mask=jnp.asarray(mask))
    assert torch.isfinite(got).all()
    _close(got, want)


def test_swiglu():
    rng = np.random.default_rng(2)
    params = jax.tree.map(np.asarray,
                          JL.init_swiglu(jax.random.PRNGKey(1), 16, 64))
    x = rng.standard_normal((4, 7, 16)).astype(np.float32)
    _close(TL.swiglu({k: torch.tensor(v) for k, v in params.items()},
                     torch.from_numpy(x)),
           JL.swiglu(params, jnp.asarray(x)))


@pytest.mark.parametrize("combiner", ["sum", "mean", "none"])
def test_embedding_bag_and_field_lookups(combiner):
    from repro.models import embedding as JE
    from repro_torch.models import embedding as TE

    rng = np.random.default_rng(5)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (4, 6))
    mask = rng.random((4, 6)) < 0.6
    mask[0] = False                       # an empty bag
    _close(TE.embedding_bag(torch.tensor(table), torch.from_numpy(ids),
                            torch.from_numpy(mask), combiner),
           JE.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(mask), combiner))
    tables = {"a": table, "b": table[::-1].copy()}
    _close(TE.field_embeddings({k: torch.tensor(v) for k, v in tables.items()},
                               torch.from_numpy(ids[:, :2]), ("a", "b")),
           JE.field_embeddings({k: jnp.asarray(v) for k, v in tables.items()},
                               jnp.asarray(ids[:, :2]), ("a", "b")))


def smoke_batch(cfg, b, seed):
    """A model-input batch (after prep) from a numpy seed."""
    rng = np.random.default_rng(seed)
    s = cfg.seq_len
    lens = rng.integers(0, s + 1, b)
    lens[0] = 0                       # an all-masked history
    return {
        "uih_item_id": rng.integers(0, cfg.item_vocab, (b, s)).astype(np.int32),
        "uih_action_type": rng.integers(0, 16, (b, s)).astype(np.int32),
        "uih_mask": np.arange(s)[None, :] >= (s - lens)[:, None],
        "cand_item_id": rng.integers(0, cfg.item_vocab, b).astype(np.int32),
        "sparse_ids": rng.integers(0, cfg.field_vocab,
                                   (b, cfg.n_sparse)).astype(np.int32),
        "dense": rng.random((b, cfg.n_dense)).astype(np.float32),
        "label": (rng.random(b) < 0.3).astype(np.float32),
    }


def reference_params(cfg):
    """The reference's ``init_dlrm_uih`` tree as numpy (jit: one compile)."""
    init = jax.jit(JR.init_dlrm_uih, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def smoke_tree():
    return reference_params(j_cfgs.SMOKE)


def _models(tree, remat):
    j_cfg = dataclasses.replace(j_cfgs.SMOKE, remat=remat)
    t_cfg = dataclasses.replace(t_cfgs.SMOKE, remat=remat)
    return j_cfg, t_cfg, tree, dlrm_uih_params_from_numpy(tree, t_cfg, "cpu")


def test_interop_keeps_the_reference_tree_layout(smoke_tree):
    j_cfg, t_cfg, tree, params = _models(smoke_tree, remat=False)
    assert params["seq_blocks"]["ln1"].shape == (t_cfg.n_seq_layers,
                                                 t_cfg.d_seq)
    ref_leaves = jax.tree.leaves(tree)
    ours = tree_leaves(params)
    assert len(ours) == len(ref_leaves)
    for a, b in zip(ours, ref_leaves):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    with pytest.raises(ValueError):
        dlrm_uih_params_from_numpy(tree, t_cfgs.FULL, "cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_dlrm_uih_forward_loss_and_grads_match_reference(smoke_tree, remat):
    j_cfg, t_cfg, tree, params = _models(smoke_tree, remat)
    batch = smoke_batch(t_cfg, 6, seed=3)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _close(TR.dlrm_uih_forward(params, tb, t_cfg),
           jax.jit(lambda p, b: JR.dlrm_uih_forward(p, b, j_cfg))(tree, jb))
    loss = TR.dlrm_uih_loss(params, tb, t_cfg)
    loss.backward()
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: JR.dlrm_uih_loss(p, b, j_cfg)))(tree, jb)
    _close(loss, j_loss)
    for got, want in zip(tree_leaves(params), jax.tree.leaves(j_grads)):
        _close(got.grad, want)


def test_normalized_entropy():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal(32).astype(np.float32)
    labels = (rng.random(32) < 0.4).astype(np.float32)
    _close(TR.normalized_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels)),
           JR.normalized_entropy(jnp.asarray(logits), jnp.asarray(labels)))
