"""The port's other ranking tenants (DCN-v2, DIEN, BERT4Rec), the four
candidate-scoring paths and the tenants' device-side preps, against the JAX
reference, float32 on the CPU.

Reference parameters go to the port through ``repro_torch.interop`` (torch
and jax draw different numbers from one seed); inputs come from numpy seeds.
Tolerance ``rtol=1e-4, atol=1e-5``, as ``tests/test_torch_recsys.py``:
both sides compute in float32, and the slack covers the summation order of
float32 matrix products. It holds parameters after one AdamW step too: a
first step moves each entry by about ``lr * g / (|g| + eps)``, so an entry
whose gradient is near zero carries the gradient's relative error into the
update at ``lr`` scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert4rec as j_bert
from repro.configs import dcn_v2 as j_dcn
from repro.configs import dien as j_dien
from repro.configs import dlrm_uih as j_dlrm
from repro.models import recsys as JR
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch import interop
from repro_torch.configs import bert4rec as t_bert
from repro_torch.configs import dcn_v2 as t_dcn
from repro_torch.configs import dien as t_dien
from repro_torch.configs import dlrm_uih as t_dlrm
from repro_torch.models import recsys as TR
from repro_torch.train.optimizer import AdamWConfig as TAdamW
from repro_torch.train.train_loop import Trainer as TTrainer
from repro_torch.train.train_loop import TrainerConfig as TTrainerConfig
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-5)
B = 6
N_CAND = 40

# name -> (reference configs, port configs, reference init, port interop)
TENANTS = {
    "dcn-v2": (j_dcn, t_dcn, JR.init_dcn_v2, interop.dcn_v2_params_from_numpy),
    "dien": (j_dien, t_dien, JR.init_dien, interop.dien_params_from_numpy),
    "bert4rec": (j_bert, t_bert, JR.init_bert4rec,
                 interop.bert4rec_params_from_numpy),
    "dlrm-uih": (j_dlrm, t_dlrm, JR.init_dlrm_uih,
                 interop.dlrm_uih_params_from_numpy),
}
THREE = ("dcn-v2", "dien", "bert4rec")
FORWARD = {"dcn-v2": (JR.dcn_v2_forward, TR.dcn_v2_forward),
           "dien": (JR.dien_forward, TR.dien_forward),
           "bert4rec": (JR.bert4rec_forward, TR.bert4rec_forward),
           "dlrm-uih": (JR.dlrm_uih_forward, TR.dlrm_uih_forward)}
LOSS = {"dcn-v2": (JR.dcn_v2_loss, TR.dcn_v2_loss),
        "dien": (JR.dien_loss, TR.dien_loss),
        "bert4rec": (JR.bert4rec_loss, TR.bert4rec_loss)}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _right_aligned(rng, b, s):
    """A right-aligned validity mask whose row 0 is all masked."""
    lens = rng.integers(1, s + 1, b)
    lens[0] = 0
    return np.arange(s)[None, :] >= (s - lens)[:, None]


def smoke_batch(name, cfg, b, seed):
    """A model-input batch (after prep) for tenant ``name`` from a numpy
    seed, with one all-masked history where the tenant reads one."""
    rng = np.random.default_rng(seed)
    label = (rng.random(b) < 0.3).astype(np.float32)
    if name == "dcn-v2":
        return {"sparse_ids": rng.integers(0, cfg.field_vocab,
                                           (b, cfg.n_sparse)).astype(np.int32),
                "dense": rng.random((b, cfg.n_dense)).astype(np.float32),
                "label": label}
    s = cfg.seq_len
    mask = _right_aligned(rng, b, s)
    out = {"uih_item_id": rng.integers(0, cfg.item_vocab, (b, s)).astype(
               np.int32),
           "uih_mask": mask,
           "cand_item_id": rng.integers(0, cfg.item_vocab, b).astype(
               np.int32)}
    if name == "dien":
        out["uih_category"] = rng.integers(0, cfg.cat_vocab, (b, s)).astype(
            np.int32)
        out["cand_category"] = rng.integers(0, cfg.cat_vocab, b).astype(
            np.int32)
        out["label"] = label
    elif name == "bert4rec":
        out["mask_pos"] = (rng.random((b, s)) < 0.3) & mask
        out["neg_ids"] = rng.integers(0, cfg.item_vocab, 32).astype(np.int32)
    else:
        out["uih_action_type"] = rng.integers(0, 16, (b, s)).astype(np.int32)
        out["sparse_ids"] = rng.integers(0, cfg.field_vocab,
                                         (b, cfg.n_sparse)).astype(np.int32)
        out["dense"] = rng.random((b, cfg.n_dense)).astype(np.float32)
        out["label"] = label
    return out


def _both(batch):
    return ({k: torch.from_numpy(v) for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})


_TREES = {}


def reference_tree(name):
    """The reference's SMOKE parameter tree for ``name`` as numpy (one jit
    compile a tenant, kept for the module)."""
    if name not in _TREES:
        j_mod, _, init, _ = TENANTS[name]
        tree = jax.jit(init, static_argnums=1)(jax.random.PRNGKey(0),
                                               j_mod.SMOKE)
        _TREES[name] = jax.tree.map(np.asarray, tree)
    return _TREES[name]


def models(name):
    j_mod, t_mod, _, to_port = TENANTS[name]
    tree = reference_tree(name)
    return j_mod.SMOKE, t_mod.SMOKE, tree, to_port(tree, t_mod.SMOKE, "cpu")


# ---------------------------------------------------------------------------
# configs and interop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
@pytest.mark.parametrize("name", THREE)
def test_configs_mirror_the_reference(name, size):
    j_mod, t_mod = TENANTS[name][:2]
    j, t = getattr(j_mod, size), getattr(t_mod, size)
    for f in dataclasses.fields(t):
        if f.name != "compute_dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.compute_dtype == (torch.bfloat16 if size == "FULL"
                               else torch.float32)
    # the port drops only the mesh and the jax lowering knobs
    dropped = {f.name for f in dataclasses.fields(j)} - {
        f.name for f in dataclasses.fields(t)}
    assert dropped <= {"mesh", "data_axes", "unroll_scans"}


@pytest.mark.parametrize("name", THREE)
def test_interop_keeps_the_tree_and_raises_on_one_that_does_not_fit(name):
    j_mod, t_mod, _, to_port = TENANTS[name]
    tree = reference_tree(name)
    params = to_port(tree, t_mod.SMOKE, "cpu")
    ours, ref = tree_leaves(params), jax.tree.leaves(tree)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    foreign = reference_tree("dlrm-uih" if name != "dlrm-uih" else "dien")
    with pytest.raises(ValueError, match="parameter tree"):
        to_port(foreign, t_mod.SMOKE, "cpu")
    smoke = t_mod.SMOKE
    if name == "dcn-v2":
        wider, fewer = dict(embed_dim=5), dict(n_cross_layers=1)
    elif name == "dien":
        wider, fewer = dict(gru_dim=17), dict(mlp=(16,))
    else:
        wider, fewer = dict(embed_dim=32), dict(n_blocks=1)
    with pytest.raises(ValueError, match="shape"):
        to_port(tree, dataclasses.replace(smoke, **wider), "cpu")
    with pytest.raises(ValueError):
        to_port(tree, dataclasses.replace(smoke, **fewer), "cpu")


# ---------------------------------------------------------------------------
# forward, loss, gradients, one AdamW step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", THREE)
def test_forward_and_loss_match_reference(name):
    j_cfg, t_cfg, tree, params = models(name)
    tb, jb = _both(smoke_batch(name, t_cfg, B, seed=3))
    j_fwd, t_fwd = FORWARD[name]
    got = t_fwd(params, tb, t_cfg)
    assert got.shape == (B,) and torch.isfinite(got).all()
    _close(got, jax.jit(lambda p, b: j_fwd(p, b, j_cfg))(tree, jb))
    j_loss, t_loss = LOSS[name]
    _close(t_loss(params, tb, t_cfg),
           jax.jit(lambda p, b: j_loss(p, b, j_cfg))(tree, jb))


@pytest.mark.parametrize("neg,loss_chunk", [
    (False, 0),         # full softmax (no neg_ids)
    (True, 4),          # sampled softmax, chunks dividing S=16
    (True, 5),          # sampled softmax, 5 does not divide S: one chunk
])
def test_bert4rec_loss_branches_match_reference(neg, loss_chunk):
    j_cfg, t_cfg, tree, params = models("bert4rec")
    j_cfg = dataclasses.replace(j_cfg, loss_chunk=loss_chunk)
    t_cfg = dataclasses.replace(t_cfg, loss_chunk=loss_chunk)
    batch = smoke_batch("bert4rec", t_cfg, B, seed=4)
    if not neg:
        del batch["neg_ids"]
    tb, jb = _both(batch)
    loss = TR.bert4rec_loss(params, tb, t_cfg)
    assert torch.isfinite(loss)
    _close(loss, jax.jit(lambda p, b: JR.bert4rec_loss(p, b, j_cfg))(tree,
                                                                     jb))


@pytest.mark.parametrize("name", THREE)
def test_loss_gradients_match_reference(name):
    j_cfg, t_cfg, tree, params = models(name)
    if name == "bert4rec":
        j_cfg = dataclasses.replace(j_cfg, loss_chunk=4)
        t_cfg = dataclasses.replace(t_cfg, loss_chunk=4)
    tb, jb = _both(smoke_batch(name, t_cfg, B, seed=5))
    j_loss, t_loss = LOSS[name]
    loss = t_loss(params, tb, t_cfg)
    loss.backward()
    want_loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss(p, b, j_cfg)))(tree, jb)
    _close(loss, want_loss)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jax.tree.leaves(grads))
    for got, want in zip(leaves, jax.tree.leaves(grads)):
        _close(got.grad, want)


@pytest.mark.parametrize("name", THREE)
def test_one_adamw_step_matches_reference(name):
    """``Trainer.run_step`` (two microbatches) in both packages from the
    same parameters and batch: the same loss and the same parameters."""
    j_cfg, t_cfg, tree, params = models(name)
    # BERT4Rec's 32 neg_ids split in two like any leaf, in both trainers
    batch = smoke_batch(name, t_cfg, 2 * B, seed=6)
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.1)
    j_loss, t_loss = LOSS[name]
    jt = JTrainer(lambda p, b: j_loss(p, b, j_cfg),
                  jax.tree.map(jnp.asarray, tree),
                  JTrainerConfig(opt=JAdamW(**opt), grad_accum=2))
    tt = TTrainer(lambda p, b: t_loss(p, b, t_cfg), params,
                  TTrainerConfig(opt=TAdamW(**opt), grad_accum=2))
    tb, jb = _both(batch)
    want = jt.run_step(jb)
    got = tt.run_step(tb)
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
    for a, b in zip(tree_leaves(tt.params), jax.tree.leaves(jt.params)):
        _close(a, b)


# ---------------------------------------------------------------------------
# the retrieval_cand paths: one user against N candidates
# ---------------------------------------------------------------------------

def _score_inputs(name, cfg, seed):
    """One user's batch (its history with some masked positions) and N
    candidates (with DIEN's candidate categories)."""
    rng = np.random.default_rng(seed)
    user = {k: v[1:2] for k, v in smoke_batch(name, cfg, 3, seed).items()
            if k not in ("mask_pos", "neg_ids", "label")}
    vocab = cfg.field_vocab if name == "dcn-v2" else cfg.item_vocab
    cands = rng.integers(0, vocab, N_CAND).astype(np.int32)
    cats = rng.integers(0, getattr(cfg, "cat_vocab", 1), N_CAND).astype(
        np.int32)
    return user, cands, cats


def _t_score(name, params, user, cands, cats, cfg):
    fn = {"dcn-v2": TR.dcn_v2_score_candidates,
          "bert4rec": TR.bert4rec_score_candidates,
          "dlrm-uih": TR.dlrm_uih_score_candidates}
    if name == "dien":
        return TR.dien_score_candidates(params, user, cands, cats, cfg)
    return fn[name](params, user, cands, cfg)


@pytest.mark.parametrize("name", list(TENANTS))
def test_score_candidates_match_reference(name):
    j_cfg, t_cfg, tree, params = models(name)
    user, cands, cats = _score_inputs(name, t_cfg, seed=7)
    tu, ju = _both(user)
    got = _t_score(name, params, tu, torch.from_numpy(cands),
                   torch.from_numpy(cats), t_cfg)
    if name == "dien":
        want = JR.dien_score_candidates(tree, ju, jnp.asarray(cands),
                                        jnp.asarray(cats), j_cfg)
    else:
        fn = {"dcn-v2": JR.dcn_v2_score_candidates,
              "bert4rec": JR.bert4rec_score_candidates,
              "dlrm-uih": JR.dlrm_uih_score_candidates}[name]
        want = fn(tree, ju, jnp.asarray(cands), j_cfg)
    assert got.shape == want.shape == ((1, N_CAND) if name == "bert4rec"
                                       else (N_CAND,))
    _close(got, want)


def per_candidate_batch(name, user, cands, cats):
    """The user's batch repeated once a candidate, with that candidate: the
    forward pass's view of what ``*_score_candidates`` scores."""
    n = len(cands)
    rows = {k: np.repeat(v, n, axis=0) for k, v in user.items()}
    if name == "dcn-v2":
        rows["sparse_ids"][:, 0] = cands
    else:
        rows["cand_item_id"] = cands
    if name == "dien":
        rows["cand_category"] = cats
    return rows


@pytest.mark.parametrize("name", list(TENANTS))
def test_score_candidates_equal_forward_per_candidate(name):
    _, t_cfg, _, params = models(name)
    user, cands, cats = _score_inputs(name, t_cfg, seed=8)
    got = _t_score(name, params, _both(user)[0], torch.from_numpy(cands),
                   torch.from_numpy(cats), t_cfg).reshape(-1)
    rows = _both(per_candidate_batch(name, user, cands, cats))[0]
    _close(got, FORWARD[name][1](params, rows, t_cfg).detach())


# ---------------------------------------------------------------------------
# feed -> device prep -> loss, against the reference's host batch
# ---------------------------------------------------------------------------

def _feed_batch(port, name, seq_len):
    """The first batch of a sim feed at the tenant's length and traits, from
    one package (same seed and knobs): the port densifies on the device
    (``device="cpu"``: the plain version), the reference on the host."""
    if port:
        from repro_torch.core import events as ev
        from repro_torch.core.projection import TenantProjection
        from repro_torch.core.simulation import ProductionSim, SimConfig
        from repro_torch.data import DatasetSpec, SimSource, open_feed
        from repro_torch.dpp.featurize import FeatureSpec
    else:
        from repro.core import events as ev
        from repro.core.projection import TenantProjection
        from repro.core.simulation import ProductionSim, SimConfig
        from repro.data import DatasetSpec, SimSource, open_feed
        from repro.dpp.featurize import FeatureSpec
    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=8, n_items=2_000, days=4,
                               events_per_user_day_mean=30.0, seed=11),
        stripe_len=16, requests_per_user_day=4, seed=11))
    sim.run_days(3, capture_reference=False)
    traits = ("item_id",) if name == "bert4rec" else ("item_id", "category")
    groups = {"core": ("item_id",)}
    if len(traits) > 1:
        groups["sideinfo"] = ("category",)
    spec = DatasetSpec(
        tenant=TenantProjection(name, seq_len=seq_len,
                                feature_groups=tuple(groups),
                                traits_per_group=groups),
        source=SimSource(min_rows=2 * B), batch_size=B, base_batch_size=3,
        prefetch_depth=2, n_workers=1, ordered=True,
        device_materialize=True,
        features=FeatureSpec(seq_len=seq_len, uih_traits=traits,
                             candidate_fields=traits,
                             label_fields=("click",)))
    feed = open_feed(spec, sim, device="cpu") if port else open_feed(spec,
                                                                     sim)
    try:
        if port:
            assert feed.prefetcher.materialize is not None   # device path
        return next(iter(feed))
    finally:
        feed.close(timeout=10.0)


def _np_prep(name, b, cfg, mask_pos=None, neg_ids=None):
    """``dien_prep``/``bert4rec_prep``'s transforms in numpy (the reference
    side); BERT4Rec's draws come from the port's batch."""
    out = {"uih_item_id": (b["uih_item_id"] % cfg.item_vocab).astype(
               np.int32),
           "uih_mask": b["uih_mask"],
           "cand_item_id": (b["cand_item_id"] % cfg.item_vocab).astype(
               np.int32)}
    if name == "dien":
        out["uih_category"] = (b["uih_category"] % cfg.cat_vocab).astype(
            np.int32)
        out["cand_category"] = (b["cand_category"] % cfg.cat_vocab).astype(
            np.int32)
        out["label"] = b["label_click"].astype(np.float32)
    else:
        out["mask_pos"] = mask_pos
        out["neg_ids"] = neg_ids
    return out


@pytest.mark.parametrize("name", ["dien", "bert4rec"])
def test_feed_prep_loss_matches_reference_host_batch(name):
    j_cfg, t_cfg, tree, params = models(name)
    got = _feed_batch(True, name, t_cfg.seq_len)
    want = {k: np.asarray(v) for k, v in _feed_batch(False, name,
                                                     t_cfg.seq_len).items()}
    for k in ("uih_item_id", "uih_mask", "cand_item_id", "label_click"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    if name == "dien":
        prepped = TR.dien_prep(got, t_cfg)
        ref = _np_prep(name, want, j_cfg)
        loss = TR.dien_loss(params, prepped, t_cfg)
        j_loss = JR.dien_loss(tree, {k: jnp.asarray(v)
                                     for k, v in ref.items()}, j_cfg)
    else:
        gen = torch.Generator().manual_seed(0)
        prepped = TR.bert4rec_prep(got, t_cfg, gen)
        assert prepped["neg_ids"].shape == (TR.N_NEGATIVES,)
        assert not (prepped["mask_pos"] & ~prepped["uih_mask"]).any()
        assert prepped["mask_pos"].any()
        ref = _np_prep(name, want, j_cfg, prepped["mask_pos"].numpy(),
                       prepped["neg_ids"].numpy())
        loss = TR.bert4rec_loss(params, prepped, t_cfg)
        j_loss = JR.bert4rec_loss(tree, {k: jnp.asarray(v)
                                         for k, v in ref.items()}, j_cfg)
    assert sorted(prepped) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(prepped[k].numpy(), ref[k], err_msg=k)
    _close(loss, j_loss)


# ---------------------------------------------------------------------------
# attention scores on a mesh: the compute dtype, as the reference
# ---------------------------------------------------------------------------
#
# The reference's DLRM-UIH and BERT4Rec encoders pass ``scores_f32=(cfg.mesh
# is None)``: on a mesh the score einsum, scale, mask and softmax run in the
# compute dtype. Held at rtol = atol = 2**-6 for one bf16 attention call (a
# bf16 unit in the last place at |x| < 4 is at most 2**-6): the port's
# compute-dtype path lies within it, its float32 path does not. The two
# encoders' SMOKE forward in bf16 on a one-device mesh is held at rtol =
# atol = 2**-5: two bf16 layers, where each side rounds its other ops
# (norms, rope, MLPs) in its own order.

from repro.models import layers as JL                 # noqa: E402
from repro_torch.models import layers as TL           # noqa: E402

BF16_ATTN_TOL = dict(rtol=2**-6, atol=2**-6)
BF16_FORWARD_TOL = dict(rtol=2**-5, atol=2**-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_attention_scores_in_the_compute_dtype_match_the_reference(causal,
                                                                   seed):
    rng = np.random.default_rng(seed)
    b, s, h, hk, dh = 4, 64, 4, 2, 16
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32) * 2
    k = rng.standard_normal((b, s, hk, dh)).astype(np.float32) * 2
    v = rng.standard_normal((b, s, hk, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    mask = np.arange(s)[None, :] >= np.array([0, 5, 20, s - 1])[:, None]
    want = np.asarray(jax.jit(lambda q, k, v: JL._attend_chunked(
        q, k, v, jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(mask),
        causal, 16, scores_f32=False))(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ).astype(jnp.float32))
    args = (*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
            torch.from_numpy(pos), torch.from_numpy(pos),
            torch.from_numpy(mask), causal, 16)
    got = TL._attend_chunked(*args, scores_f32=False)
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, **BF16_ATTN_TOL)
    old = TL._attend_chunked(*args, scores_f32=True).float().numpy()
    assert not np.allclose(old, want, **BF16_ATTN_TOL)


@pytest.mark.parametrize("name", ["dlrm-uih", "bert4rec"])
def test_encoders_on_a_mesh_score_in_the_compute_dtype(name, monkeypatch):
    """SMOKE DLRM-UIH and BERT4Rec in bf16 on a one-device mesh: the
    port's forward equals the reference's serving cell on the same
    parameters and batch, and the encoders' attention ran in the compute
    dtype (in float32 without a mesh, and in the candidate scorers)."""
    import torch.distributed as dist
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_arch as j_get_arch
    from repro.launch.mesh import set_mesh
    from repro.launch.sampling import sample_args as j_sample_args
    from repro.launch.steps import build_cell as j_build_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import tree_map

    j_mod, t_mod, _, to_port = TENANTS[name]
    # the reference's mesh path runs under jit on a mesh whose axes let
    # its sharding constraints propagate (its test mesh's explicit axes
    # would need every gather's output sharding spelled out)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    smoke = dataclasses.replace(j_mod.SMOKE, compute_dtype=jnp.bfloat16)
    cell = j_build_cell(j_get_arch(name), "serve_p99", jmesh, use_full=True,
                        cfg_override=smoke)
    assert cell.meta["cfg"].mesh is jmesh
    args = j_sample_args(cell, "recsys", 0)
    shardings = jax.tree.map(lambda p: NamedSharding(jmesh, p),
                             cell.in_shardings,
                             is_leaf=lambda x: isinstance(x, JP))
    with set_mesh(jmesh):
        want = jax.jit(cell.step_fn)(*jax.device_put(args, shardings))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), args[0])
    params = tree_map(lambda p: p.detach().to(torch.bfloat16),
                      to_port(tree, t_mod.SMOKE, "cpu"))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in args[1].items()}
    seen = []
    attend = TL._attend_chunked

    def spy(*a, **kw):
        seen.append(a[8] if len(a) > 8 else kw.get("scores_f32", True))
        return attend(*a, **kw)

    monkeypatch.setattr(TL, "_attend_chunked", spy)
    mesh = make_test_mesh(1, "cpu")
    try:
        cfg = dataclasses.replace(t_mod.SMOKE, compute_dtype=torch.bfloat16,
                                  mesh=mesh)
        with torch.no_grad():
            got = FORWARD[name][1](params, batch, cfg)
            assert seen and not any(seen)
            seen.clear()
            FORWARD[name][1](params, batch,
                             dataclasses.replace(cfg, mesh=None))
            assert seen and all(seen)
    finally:
        dist.destroy_process_group()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           **BF16_FORWARD_TOL)
