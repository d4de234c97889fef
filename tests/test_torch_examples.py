"""The port's examples (``examples_torch/``) against the reference's
(``examples/``), both at ``--device cpu`` on the same sim seeds.

The example modules are loaded from their files (neither directory is a
package). Where an example draws parameters, the reference's are drawn with
its ``PRNGKey(0)`` and carried into the port through ``repro_torch.interop``
(jax and torch draw different numbers from one seed). The loss trajectory
is held at ``rtol=1e-3``, the tolerance of ``tests/test_torch_slice.py``:
float32 reduction-order differences compound through AdamW.
"""
import importlib.util
import threading
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_uih as j_dlrm_uih
from repro.dpp.worker import DPPWorker as JDPPWorker
from repro.models import recsys as JR
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import dlrm_uih as t_dlrm_uih
from repro_torch.interop import (bert4rec_params_from_numpy,
                                 dlrm_uih_params_from_numpy,
                                 two_tower_params_from_numpy)

REPO = Path(__file__).resolve().parent.parent
STEPS = 20


def _load(directory: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"{directory}_{name}", REPO / directory / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_cfg(port_cfg, jcls):
    """The reference's config with the port example's fields (the
    reference builds the same one inside its ``main``)."""
    fields = {f: getattr(port_cfg, f) for f in jcls.__dataclass_fields__
              if f != "compute_dtype" and hasattr(port_cfg, f)}
    return jcls(**fields, compute_dtype=jnp.float32)


# ---------------------------------------------------------------------------
# train_seqrec
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seqrec():
    """Both examples, one sim each, the reference's parameters and its
    loss trajectory over ``STEPS`` steps."""
    ref, port = _load("examples", "train_seqrec"), _load("examples_torch",
                                                         "train_seqrec")
    t_cfg = port.CONFIGS["example"]
    j_cfg = _reference_cfg(t_cfg, JR.DLRMUIHConfig)
    tree = _numpy_tree(JR.init_dlrm_uih(jax.random.PRNGKey(0), j_cfg))
    j_sim, t_sim = ref.build_sim(), port.build_sim()
    jt = JTrainer(lambda p, b: JR.dlrm_uih_loss(p, b, j_cfg),
                  jax.tree.map(jnp.asarray, tree),
                  JTrainerConfig(opt=JAdamW(lr=1e-3, warmup_steps=20,
                                            total_steps=STEPS),
                                 ckpt_every=50, grad_accum=2, log_every=20))
    feed = ref.open_feed(ref.dataset_spec(STEPS, prefetch=True), j_sim,
                         prep_fn=lambda b: ref.prep(b, j_cfg),
                         controller=ref.ElasticController(
                             ref.ElasticConfig(min_workers=1, max_workers=8)))
    try:
        jt.fit(feed, max_steps=STEPS)
    finally:
        feed.close(timeout=10.0)
    return {"ref": ref, "port": port, "j_cfg": j_cfg, "t_cfg": t_cfg,
            "tree": tree, "j_sim": j_sim, "t_sim": t_sim,
            "losses": [h["loss"] for h in jt.history]}


def _port_losses(seqrec, tmp_path, *flags):
    port, cfg = seqrec["port"], seqrec["t_cfg"]
    args = port.parse_args(["--steps", str(STEPS), "--ckpt-dir",
                            str(tmp_path), "--device", "cpu", *flags])
    params = dlrm_uih_params_from_numpy(seqrec["tree"], cfg, "cpu")
    trainer = port.train(args, cfg, params, sim=seqrec["t_sim"])
    return [h["loss"] for h in trainer.history]


def test_train_seqrec_first_batches_byte_equal(seqrec):
    ref, port = seqrec["ref"], seqrec["port"]
    feeds = [
        ref.open_feed(ref.dataset_spec(STEPS, prefetch=False), seqrec["j_sim"],
                      prep_fn=lambda b: ref.prep(b, seqrec["j_cfg"])),
        port.open_feed(port.dataset_spec(STEPS, prefetch=False),
                       seqrec["t_sim"], device="cpu",
                       prep_fn=lambda b: port.prep(b, seqrec["t_cfg"])),
    ]
    try:
        want, got = ([next(it) for _ in range(4)]
                     for it in map(iter, feeds))
    finally:
        for f in feeds:
            f.close(timeout=10.0)
    for w, g in zip(want, got):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_train_seqrec_loss_trajectory_matches_reference(seqrec, tmp_path,
                                                         capsys):
    got = _port_losses(seqrec, tmp_path)
    assert len(got) == len(seqrec["losses"]) == STEPS
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, seqrec["losses"], rtol=1e-3)
    out = capsys.readouterr().out
    assert f"trained {STEPS} steps in" in out and "loss " in out


def test_train_seqrec_no_prefetch_gives_the_same_losses(seqrec, tmp_path):
    with_prefetch = _port_losses(seqrec, tmp_path / "a")
    without = _port_losses(seqrec, tmp_path / "b", "--no-prefetch")
    np.testing.assert_array_equal(without, with_prefetch)


def test_train_seqrec_prep_copies_once(seqrec):
    """With prefetch the prepped batch is host arrays, which the
    ``DevicePrefetcher`` copies to the device once; with ``--no-prefetch``
    ``prep`` puts the same bytes on the device itself."""
    port, cfg = seqrec["port"], seqrec["t_cfg"]
    feed = port.open_feed(port.dataset_spec(STEPS, prefetch=False),
                          seqrec["t_sim"], device="cpu")
    try:
        b = next(iter(feed))
    finally:
        feed.close(timeout=10.0)
    host = port.prep(b, cfg)
    dev = port.prep(b, cfg, torch.device("cpu"))
    assert all(isinstance(v, np.ndarray) for v in host.values())
    assert list(dev) == list(host)
    for k, v in dev.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), host[k], err_msg=k)


def test_train_seqrec_resume_continues_from_the_step_50_checkpoint(
        seqrec, tmp_path, capsys):
    port = seqrec["port"]
    flags = ["--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first = port.main(["--steps", "50", *flags])
    assert first.step == 50 and (tmp_path / f"step_{50:09d}").is_dir()
    capsys.readouterr()
    again = port.main(["--steps", "53", "--resume", *flags])
    out = capsys.readouterr().out
    assert "resumed from step 50" in out
    assert again.step == 53 and len(again.history) == 3
    assert "trained 53 steps in" in out


def test_train_seqrec_full_config_is_the_reference_full():
    port = _load("examples_torch", "train_seqrec")
    args = port.parse_args(["--config", "full"])
    assert args.config == "full" and args.device == "cuda"
    cfg = port.CONFIGS[args.config]
    assert cfg is t_dlrm_uih.FULL
    want = j_dlrm_uih.FULL
    # the reference's extra field is a jax scan-unrolling knob
    assert (set(want.__dataclass_fields__) - set(cfg.__dataclass_fields__)
            == {"unroll_scans"})
    for f in cfg.__dataclass_fields__:
        if f == "compute_dtype":
            assert cfg.compute_dtype == torch.bfloat16
            assert want.compute_dtype == jnp.bfloat16
        else:
            assert getattr(cfg, f) == getattr(want, f), f
    spec = port.dataset_spec(19, prefetch=True, seq_len=cfg.seq_len)
    assert spec.tenant.seq_len == spec.features.seq_len == 2048
    rng = np.random.default_rng(0)
    mask = rng.random((4, 2048)) < 0.3
    b = {"uih_item_id": rng.integers(0, 1 << 40, (4, 2048)),
         "uih_action_type": rng.integers(0, 40, (4, 2048)),
         "uih_mask": mask, "cand_item_id": rng.integers(0, 1 << 40, 4),
         "user_id": rng.integers(0, 1 << 30, 4),
         "label_click": (rng.random(4) < 0.5).astype(np.float32)}
    x = port.prep(b, cfg)
    assert x["sparse_ids"].shape == (4, cfg.n_sparse) == (4, 4)
    assert x["dense"].shape == (4, cfg.n_dense) == (4, 13)
    np.testing.assert_array_equal(
        x["dense"][:, 0], (mask.sum(1).astype(np.float32) / np.float32(2048)))
    assert x["uih_item_id"].max() < cfg.item_vocab
    assert x["sparse_ids"].max() < cfg.field_vocab


def test_examples_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("train_seqrec", "train_streaming", "serve_retrieval",
                 "streaming_vs_batch"):
        with pytest.raises(RuntimeError, match="is_available"):
            _load("examples_torch", name).main(["--device", "cuda"])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_prints_the_reference_lines(capsys):
    _load("examples", "quickstart").main()
    want = capsys.readouterr().out
    _load("examples_torch", "quickstart").main()
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert "O2O-exact vs inference state: True" in got
    assert "future leakage events:       0" in got


# ---------------------------------------------------------------------------
# streaming_vs_batch
# ---------------------------------------------------------------------------

def test_streaming_vs_batch_matches_reference(monkeypatch, capsys):
    ref = _load("examples", "streaming_vs_batch")
    recorded = []

    class RecordingWorker(JDPPWorker):
        """The reference's workers, each keeping the batches it made."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.made = []
            recorded.append(self.made)

        def process(self, examples):
            out = super().process(examples)
            self.made.append(out)
            return out

    monkeypatch.setattr(ref, "DPPWorker", RecordingWorker)
    ref.main()
    want_out = capsys.readouterr().out
    port = _load("examples_torch", "streaming_vs_batch")
    j_cfg = _reference_cfg(port.MODEL, JR.BERT4RecConfig)
    params = bert4rec_params_from_numpy(
        _numpy_tree(JR.init_bert4rec(jax.random.PRNGKey(0), j_cfg)),
        port.MODEL, "cpu")
    got = port.main(["--device", "cpu"], params=params)
    out = capsys.readouterr().out
    assert got["mismatches"] == 0
    assert "0 feature mismatches across 8 batches" in out
    assert out.splitlines() == want_out.splitlines()
    stream_ref, replay_ref = recorded
    assert len(got["stream_batches"]) == len(stream_ref) >= 8
    for g, w in zip(got["stream_batches"] + got["replay_batches"],
                    stream_ref + replay_ref):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for s1, s2 in got["scores"]:
        assert np.allclose(s1, s2)      # the reference's jnp.allclose


# ---------------------------------------------------------------------------
# serve_retrieval
# ---------------------------------------------------------------------------

def test_serve_retrieval_top_k_equals_reference(monkeypatch, capsys):
    ref = _load("examples", "serve_retrieval")
    want = []

    class Recording(ThreadPoolExecutor):
        def map(self, fn, *iterables, **kw):
            out = list(super().map(fn, *iterables, **kw))
            want.extend(out)
            return iter(out)

    monkeypatch.setattr(ref, "ThreadPoolExecutor", Recording)
    monkeypatch.setattr("sys.argv", ["serve_retrieval.py", "--requests", "64"])
    ref.main()
    capsys.readouterr()
    port = _load("examples_torch", "serve_retrieval")
    j_cfg = _reference_cfg(port.MODEL, JR.TwoTowerConfig)
    params = two_tower_params_from_numpy(
        _numpy_tree(JR.init_two_tower(jax.random.PRNGKey(0), j_cfg)),
        port.MODEL, "cpu")
    got = port.main(["--requests", "64", "--device", "cpu"], params=params)
    out = capsys.readouterr().out
    assert "no leaked leases: True" in out
    assert len(got) == len(want) == 64
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.item_ids),
                                      np.asarray(w.item_ids))
        assert g.generation == w.generation


# ---------------------------------------------------------------------------
# train_streaming
# ---------------------------------------------------------------------------

def test_train_streaming_matches_reference_backfill(monkeypatch, capsys):
    """At 1 history day and 1 live day. The port opens its feed before the
    live producer starts (the backfill's sealed hour range); the reference
    starts the producer first, so its producer start is deferred here until
    its feed is open, and both replay the same sealed history."""
    ref = _load("examples", "train_streaming")
    deferred = []

    class DeferredThread(threading.Thread):
        def start(self):
            deferred.append(self)

    real_open = ref.open_feed

    def open_then_start(*a, **kw):
        feed = real_open(*a, **kw)
        for t in deferred:
            threading.Thread.start(t)
        return feed

    monkeypatch.setattr(ref, "threading",
                        types.SimpleNamespace(Thread=DeferredThread))
    monkeypatch.setattr(ref, "open_feed", open_then_start)
    monkeypatch.setattr("sys.argv", ["train_streaming.py", "--history-days",
                                     "1", "--live-days", "1"])
    ref.main()
    want_out = capsys.readouterr().out
    monkeypatch.undo()
    handoff = next(ln for ln in want_out.splitlines()
                   if ln.startswith("catch-up handoff:"))
    want_warehouse = int(handoff.split()[2])

    port = _load("examples_torch", "train_streaming")
    got = port.main(["--history-days", "1", "--live-days", "1",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert got["warehouse_examples"] == want_warehouse > 0
    assert got["stream_examples"] > 0
    assert got["warehouse_examples"] + got["stream_examples"] == got["total"]
    assert f"-> {got['total']}/{got['total']} trained exactly once" in out
    assert got["leases_acquired"] == got["leases_released"] > 0
    assert got["leased"] == {} and got["stale_failures"] == 0
    assert got["steps"] >= 1 and all(np.isfinite(got["losses"]))
