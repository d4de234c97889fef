"""The port's training substrate against the JAX reference: AdamW (schedule,
clip, stacked-norm decay), microbatch accumulation, int8 error feedback, and
checkpoints that cross between the packages.

Float tolerance ``rtol=1e-6, atol=1e-7`` for optimizer state: both sides run
the same float32 formula; the slack is a last-place rounding difference
(fused multiply-add vs separate ops in the elementwise kernels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.kernels.adamw import ops as aw_ops
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optimizer as topt
from repro_torch.train.train_loop import Trainer as TTrainer
from repro_torch.train.train_loop import TrainerConfig as TTrainerConfig
from repro_torch.tree import to_parameter_dict, tree_leaves

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(rng):
    """A small tree with the DLRM-UIH layout's cases: a matrix, a bias, and
    per-layer norms stacked on axis 0 (2-D, so decayed)."""
    return {
        "w": rng.standard_normal((8, 4)).astype(np.float32),
        "b": rng.standard_normal(4).astype(np.float32),
        "seq_blocks": {"ln1": np.ones((2, 16), np.float32)},
    }


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict) else torch.tensor(v))
            for k, v in tree.items()}


def _assert_tree_close(got, want, **tol):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a.detach()), np.asarray(b),
                                   **(tol or TOL))


def test_lr_schedule_matches_reference():
    cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    tcfg = topt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(topt.lr_schedule(step, tcfg),
                                   jopt.lr_schedule(jnp.asarray(step), cfg),
                                   rtol=1e-6)


def _three_adamw_steps(grad_scale=1.0, given=False):
    """Three AdamW steps and one with zero gradients, port against
    reference. The port is handed each gradient over ``grad_scale`` (a
    power of two: exact) with ``grad_scale``, as ``Trainer`` hands the
    microbatch sum and 1/n, and with ``given`` the norm of what it is
    handed, as the ZeRO step hands the norm over every rank's shards."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=0.05, warmup_steps=0, total_steps=10, weight_decay=0.1,
              grad_clip=0.5)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp, js = params, jopt.adamw_init(params)
    tp = _torch_tree(params)
    ts = topt.adamw_init(tp)

    def port_step(tp, ts, grads):
        handed = _torch_tree(jax.tree.map(
            lambda g: g / np.float32(grad_scale), grads))
        gnorm = (aw_ops.global_norm(tree_leaves(handed)) if given else None)
        return topt.adamw_update(tp, handed, ts, tcfg, gnorm=gnorm,
                                 grad_scale=grad_scale)

    for _ in range(3):
        grads = _tree(rng)
        grads["seq_blocks"]["ln1"] = rng.standard_normal((2, 16)).astype(
            np.float32)
        jp, js, jstats = jopt.adamw_update(jp, grads, js, jcfg)
        tp, ts, tstats = port_step(tp, ts, grads)
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tstats["lr"], float(jstats["lr"]),
                                   rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    _assert_tree_close(tp, jp)
    _assert_tree_close(ts.m, js.m)
    _assert_tree_close(ts.v, js.v)
    # the stacked norms are 2-D: zero gradients still move them (decay)
    z = {k: np.zeros_like(v) for k, v in params.items() if k != "seq_blocks"}
    z["seq_blocks"] = {"ln1": np.zeros((2, 16), np.float32)}
    before = tp["seq_blocks"]["ln1"].clone()
    tp, ts, _ = port_step(tp, ts, z)
    jp, js, _ = jopt.adamw_update(jp, z, js, jcfg)
    assert not torch.equal(tp["seq_blocks"]["ln1"], before)
    _assert_tree_close(tp, jp)


def test_three_adamw_steps_match_including_stacked_norm_decay():
    _three_adamw_steps()


@pytest.mark.parametrize("grad_scale,given", [(0.5, False), (0.25, False),
                                              (1.0, True), (0.5, True)])
def test_adamw_takes_the_microbatch_scale_and_a_given_norm(grad_scale,
                                                          given):
    _three_adamw_steps(grad_scale, given)


def _leaves(shapes, dtype=torch.float32):
    return [torch.ones(s, dtype=dtype) for s in shapes]


_HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.95, bc1=0.1, bc2=0.05, eps=1e-8,
              clip=1.0)


@pytest.mark.parametrize("case", ["lists", "shapes", "dtype", "devices",
                                  "empty", "gnorm"])
def test_adamw_wrapper_refuses_what_it_cannot_update(case):
    p, g, m, v = (_leaves([(3, 2), (4,)]) for _ in range(4))
    decay = [0.01, 0.0]
    gnorm = None
    want = ValueError
    if case == "lists":
        g = g[:1]
    elif case == "shapes":
        v[1] = torch.ones(5)
    elif case == "dtype":
        g = _leaves([(3, 2), (4,)], torch.float64)
        want = TypeError
    elif case == "devices":        # neither all CUDA nor all CPU
        m[0] = torch.ones((3, 2), device="meta")
    elif case == "empty":
        p = g = m = v = decay = []
    else:
        gnorm = torch.ones(2)
    with pytest.raises(want):
        aw_ops.adamw(p, g, m, v, decay, **_HYPER, gnorm=gnorm)


def test_adamw_on_cpu_leaves_runs_the_plain_version(monkeypatch):
    calls = []
    plain = aw_ops.adamw_ref
    monkeypatch.setattr(aw_ops, "adamw_ref",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    before = (aw_ops.adamw.launches, aw_ops.adamw.leaves,
              aw_ops.adamw.elements, aw_ops.adamw.uploads)
    p, g, m, v = (_leaves([(3, 2), (4,)]) for _ in range(4))
    table = aw_ops.LeafTable()
    norm = aw_ops.adamw(p, g, m, v, [0.01, 0.0], **_HYPER, grad_scale=0.5,
                        table=table)
    assert calls == [1] and table.key is None    # nothing copied to a card
    assert float(norm) == pytest.approx(0.5 * 10 ** 0.5, rel=1e-6)
    assert (aw_ops.adamw.launches, aw_ops.adamw.leaves,
            aw_ops.adamw.elements, aw_ops.adamw.uploads) == before


def test_adamw_leaf_table_chunks_and_alignment():
    c = aw_ops.CHUNK
    ptrs = [[256, 260, 512], [1024, 2048, 4096], [16, 16, 24], [32, 36, 48]]
    rows = aw_ops.leaf_rows(ptrs, [1, 2 * c + 3, c], [0.0, 0.01, 0.02])
    assert rows.dtype.itemsize == 56            # the kernel's struct Leaf
    assert rows["chunk0"].tolist() == [0, 1, 4]
    assert rows["n"].tolist() == [1, 2 * c + 3, c]
    # bit i: array i (p, g, m, v) starts 16-byte aligned
    assert rows["aligned"].tolist() == [1 | 2 | 4 | 8, 2 | 4, 1 | 2 | 8]
    assert rows["p"].tolist() == ptrs[0] and rows["v"].tolist() == ptrs[3]
    np.testing.assert_array_equal(rows["decay"],
                                  np.float32([0.0, 0.01, 0.02]))


def _quad(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 8)).astype(np.float32)
    y = x @ rng.standard_normal((8, 4)).astype(np.float32)
    params = {"w": np.zeros((8, 4), np.float32),
              "b": np.zeros(4, np.float32)}
    return {"x": x, "y": y}, params


def _jloss(p, b):
    return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _tloss(p, b):
    return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _opt_kw():
    return dict(lr=0.05, warmup_steps=0, total_steps=20)


@pytest.mark.parametrize("compress", [False, True])
def test_grad_accum_matches_reference_and_full_batch(compress):
    batch, params = _quad()
    jt = JTrainer(_jloss, jax.tree.map(jnp.asarray, params),
                  JTrainerConfig(opt=jopt.AdamWConfig(**_opt_kw()),
                                 grad_accum=2, compress_grads=compress))
    runs = {}
    for accum in (1, 2):
        runs[accum] = TTrainer(
            _tloss, to_parameter_dict(params),
            TTrainerConfig(opt=topt.AdamWConfig(**_opt_kw()),
                           grad_accum=accum, compress_grads=compress))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jt.run_step({k: jnp.asarray(v) for k, v in batch.items()})
        for t in runs.values():
            t.run_step(tb)
    for a, b in zip(jt.history, runs[2].history):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    _assert_tree_close(runs[2].params, jt.params, rtol=1e-5, atol=1e-6)
    if not compress:
        # the mean of two equal microbatch means is the full-batch mean
        _assert_tree_close(runs[2].params,
                           {k: v.detach().numpy()
                            for k, v in runs[1].params.items()},
                           rtol=1e-5, atol=1e-6)


def test_quantize_int8_and_error_feedback_are_bit_exact():
    rng = np.random.default_rng(5)
    for scale in (1e-3, 1.0, 1e4):
        x = (rng.standard_normal((64, 33)) * scale).astype(np.float32)
        q, s = tgc.quantize_int8(torch.from_numpy(x))
        jq, js = jgc.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(s.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
        np.testing.assert_array_equal(
            tgc.dequantize_int8(q, s).numpy().view(np.int32),
            np.asarray(jgc.dequantize_int8(jq, js)).view(np.int32))
    grads = {"a": rng.standard_normal((5, 3)).astype(np.float32),
             "b": rng.standard_normal(7).astype(np.float32)}
    jstate, tstate = jgc.ef_init(grads), tgc.ef_init(_torch_tree(grads))
    for _ in range(2):
        jd, jstate = jgc.compress_with_feedback(grads, jstate)
        td, tstate = tgc.compress_with_feedback(_torch_tree(grads), tstate)
        for a, b in zip(tree_leaves(td) + tree_leaves(tstate.residual),
                        jax.tree.leaves(jd) + jax.tree.leaves(jstate.residual)):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))
    assert tgc.wire_bytes(_torch_tree(grads), True) == jgc.wire_bytes(
        grads, True)


def test_reference_checkpoint_restores_into_the_port_and_back(tmp_path):
    batch, params = _quad(1)
    kw = _opt_kw()
    jt = JTrainer(_jloss, jax.tree.map(jnp.asarray, params),
                  JTrainerConfig(opt=jopt.AdamWConfig(**kw),
                                 ckpt_dir=str(tmp_path / "ref"),
                                 ckpt_every=2))
    for _ in range(2):                         # autosaves at step 2
        jt.run_step({k: jnp.asarray(v) for k, v in batch.items()})
    tt = TTrainer(_tloss, to_parameter_dict(params),
                  TTrainerConfig(opt=topt.AdamWConfig(**kw),
                                 ckpt_dir=str(tmp_path / "ref")))
    assert tt.try_resume() and tt.step == 2
    _assert_tree_close(tt.params, jt.params, rtol=0, atol=0)
    _assert_tree_close(tt.opt_state.m, jt.opt_state.m, rtol=0, atol=0)
    _assert_tree_close(tt.opt_state.v, jt.opt_state.v, rtol=0, atol=0)
    assert int(tt.opt_state.step) == int(jt.opt_state.step)
    # and the port's checkpoint restores into the reference
    tt.run_step({k: torch.from_numpy(v) for k, v in batch.items()})
    tt.ckpt = type(tt.ckpt)(str(tmp_path / "port"))
    tt.save()
    jt2 = JTrainer(_jloss, jax.tree.map(jnp.asarray, params),
                   JTrainerConfig(opt=jopt.AdamWConfig(**kw),
                                  ckpt_dir=str(tmp_path / "port")))
    assert jt2.try_resume() and jt2.step == 3
    _assert_tree_close(tt.params, jt2.params, rtol=0, atol=0)
    _assert_tree_close(tt.opt_state.v, jt2.opt_state.v, rtol=0, atol=0)


def test_checkpoint_keeps_bfloat16_bytes(tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager

    state = {"a": torch.arange(10, dtype=torch.float32),
             "nested": {"b": torch.randn(3, 3).to(torch.bfloat16)}}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, state, extra={"note": "hi"})
    restored, step, extra = mgr.restore(state)
    assert step == 5 and extra["note"] == "hi"
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], state["nested"]["b"])
