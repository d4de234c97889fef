"""The port's streaming leg against the JAX reference: micro-batching, the
backfill -> live handoff, ``ReplayFilter`` state, ``open_feed`` over a
``StreamSource``, kill-and-resume across the flip, and the DLRM-UIH loss on
streamed batches.

Every test builds twin sims from one ``SimConfig`` (same seed) in both
packages: the host data plane is a copy, so request ids, batches and resume
cursors agree exactly. The loss agrees within ``rtol=1e-3`` (float32
reduction order, as in ``test_torch_slice``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_uih as j_cfgs
from repro.models import recsys as JR
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import dlrm_uih as t_cfgs
from repro_torch.interop import dlrm_uih_params_from_numpy
from repro_torch.models import recsys as TR
from repro_torch.train.optimizer import AdamWConfig as TAdamW
from repro_torch.tree import to_parameter_dict

MS_PER_HOUR = 3_600_000
PACKAGES = ("repro", "repro_torch")


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _sim(pkg, users=6, days=2, seed=9, live_days=0, close=True):
    """``tests/conftest.make_sim``'s standard pinned sim in ``pkg``; with
    ``live_days`` the last days are published only after the returned
    sealed hour (``h_sealed``) and reach the stream as live traffic."""
    ev = _m(pkg, "core.events")
    S = _m(pkg, "core.simulation")
    sim = S.ProductionSim(S.SimConfig(
        stream=ev.StreamConfig(n_users=users, n_items=1_500, days=days + 2,
                               events_per_user_day_mean=25.0, seed=seed),
        stripe_len=16, requests_per_user_day=3, seed=seed,
        pin_generations=True))
    sim.run_days(days - live_days)
    h_sealed = max(e.request_ts // MS_PER_HOUR for e in sim.examples)
    for day in range(days - live_days, days):
        sim.run_day(day, capture_reference=True)
    if close:
        sim.stream.close()
    return sim, h_sealed


def _spec(pkg, source_kw, seq_len=16, **kw):
    data = _m(pkg, "data")
    proj = _m(pkg, "core.projection")
    feat = _m(pkg, "dpp.featurize")
    kw.setdefault("batch_size", 8)
    kw.setdefault("base_batch_size", 4)
    kw.setdefault("n_workers", 2)
    kw.setdefault("prefetch_depth", 0)
    kw.setdefault("window_cache_size", 0)
    traits = ("timestamp", "item_id", "action_type")
    # a long deadline: a closed stream's micro-batches then flush on size
    # alone, so both packages cut the same work items
    source_kw.setdefault("micro_batch_delay_s", 5.0)
    return data.DatasetSpec(
        tenant=proj.TenantProjection("t", seq_len, ("core",),
                                     traits_per_group={"core": traits}),
        source=data.StreamSource(**source_kw),
        features=feat.FeatureSpec(seq_len=seq_len,
                                  uih_traits=("item_id", "action_type")),
        **kw)


def _host(batch):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in batch.items()}


def _assert_same_bytes(want, got):
    assert len(want) == len(got) > 0
    for i, (x, y) in enumerate(zip(want, got)):
        x, y = _host(x), _host(y)
        assert list(x) == list(y), i
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            assert x[k].tobytes() == y[k].tobytes(), f"batch {i} key {k}"


def _keys(batches):
    return sorted((int(u), int(t), int(c)) for b in batches
                  for u, t, c in zip(_host(b)["user_id"],
                                     _host(b)["request_ts"],
                                     _host(b)["cand_item_id"]))


def _example_keys(examples):
    return sorted((e.user_id, e.request_ts, e.candidate["item_id"])
                  for e in examples)


# ---------------------------------------------------------------------------
# StreamingSource and BackfillCoordinator
# ---------------------------------------------------------------------------

def test_micro_batch_size_flushes_match_reference():
    runs = {}
    for pkg in PACKAGES:
        sim, _ = _sim(pkg)
        st = _m(pkg, "streaming")
        src = st.StreamingSource(sim.stream, st.MicroBatchConfig(
            max_examples=5, max_delay_s=5.0, poll_s=0.005))
        mbs = [[e.request_id for e in mb] for mb in src.micro_batches()]
        src.ack([rid for mb in mbs for rid in mb])
        runs[pkg] = (mbs, src.stats.size_flushes, src.stats.drain_flushes,
                     src.stats.examples, sim.stream.pending_leases())
    ref, port = runs["repro"], runs["repro_torch"]
    assert port == ref
    mbs, size_flushes, drain_flushes, n, pending = port
    assert all(len(mb) == 5 for mb in mbs[:-1]) and len(mbs[-1]) <= 5
    assert size_flushes == len(mbs) - drain_flushes and drain_flushes <= 1
    assert n == sum(map(len, mbs)) > 0 and pending == 0


def _handoff(pkg):
    """tests/test_streaming.py:266 in ``pkg``: history sealed, coordinator
    formed, then a live day published and the stream closed."""
    sim, _ = _sim(pkg, users=8, days=2, seed=7, close=False)
    n_history = len(sim.examples)
    st = _m(pkg, "streaming")
    src = st.StreamingSource(sim.stream, st.MicroBatchConfig(max_examples=8))
    coord = st.BackfillCoordinator(sim.warehouse, src, micro_batch=8)
    sim.run_day(2, capture_reference=True)   # live traffic + a gen flip
    sim.stream.close()
    trained = [e.request_id for mb in coord.micro_batches() for e in mb]
    src.ack(trained)
    return sim, n_history, trained, coord.stats


def test_backfill_handoff_same_order_and_exactly_once():
    (rsim, rn, rtrained, rst), (sim, n, trained, st) = (
        _handoff(pkg) for pkg in PACKAGES)
    assert trained == rtrained                 # same order, id for id
    assert vars(st) == vars(rst)
    assert sorted(trained) == sorted(e.request_id for e in sim.examples)
    assert len(set(trained)) == len(trained)
    assert st.warehouse_examples == st.duplicates_skipped == n == rn
    assert st.stream_examples == len(sim.examples) - n > 0
    assert st.watermark == n - 1 and st.flipped
    assert sim.stream.pending_leases() == rsim.stream.pending_leases() == 0


def test_backfill_sweeps_contiguous_hours_with_gaps_like_reference():
    """tests/test_streaming.py:296: empty overnight hours read as empty."""
    out = {}
    for pkg in PACKAGES:
        sim, _ = _sim(pkg, users=4, seed=9)
        st = _m(pkg, "streaming")
        src = st.StreamingSource(sim.stream,
                                 st.MicroBatchConfig(max_examples=16))
        coord = st.BackfillCoordinator(sim.warehouse, src, micro_batch=16)
        ids = [e.request_id for mb in coord.micro_batches() for e in mb]
        hours = sim.warehouse.hours()
        assert coord.stats.hours_replayed == hours[-1] - hours[0] + 1
        assert coord.stats.empty_hours > 0
        assert len(ids) == coord.stats.warehouse_examples == len(sim.examples)
        out[pkg] = (ids, vars(coord.stats))
    assert out["repro_torch"] == out["repro"]


@pytest.mark.parametrize("state", [
    {},
    {"skip_rows": 17},
    {"skip_rows": 40, "drop_lo": 39, "drop_hi": 55},
    {"drop_lo": 3, "drop_hi": 2},
])
def test_replay_filter_state_matches_reference(state):
    ref = _m("repro", "streaming").ReplayFilter
    port = _m("repro_torch", "streaming").ReplayFilter
    got, want = port.from_state(state), ref.from_state(state)
    assert got.to_state() == want.to_state()
    assert port(**got.to_state()) == got
    assert port.from_state(got.to_state()).to_state() == want.to_state()


# ---------------------------------------------------------------------------
# open_feed over a StreamSource
# ---------------------------------------------------------------------------

def test_open_feed_stream_batches_equal_reference_byte_for_byte():
    """Backfill over the sealed hours, then the live day; the port's feed
    runs its device-prefetch stage on the CPU, the reference's is the host
    feed. Batches agree one for one, byte for byte."""
    feeds = {}
    for pkg in PACKAGES:
        sim, h = _sim(pkg, days=3, live_days=1)
        spec = _spec(pkg, {"backfill_end_hour": h}, generations="pinned",
                     consistency="audit", reshuffle_seed=3, ordered=True,
                     prefetch_depth=2 if pkg == "repro_torch" else 0)
        kw = {"device": "cpu"} if pkg == "repro_torch" else {}
        feed = _m(pkg, "data").open_feed(spec, sim, **kw)
        batches = []
        for b in feed:
            batches.append(b)
            feed.record_train_step(0.001)
        # each step settled its batch's freshness, through the prefetcher
        assert feed.session.freshness.rows_settled == len(sim.examples)
        feed.join()
        feeds[pkg] = (sim, feed, batches)
    rsim, rfeed, want = feeds["repro"]
    sim, feed, got = feeds["repro_torch"]
    assert feed.prefetcher is not None
    assert all(isinstance(v, torch.Tensor) for b in got for v in b.values())
    _assert_same_bytes(want, got)
    assert _keys(got) == _example_keys(sim.examples)      # exactly once
    bf, rbf = feed.session.backfill_stats, rfeed.session.backfill_stats
    assert vars(bf) == vars(rbf)
    assert bf.warehouse_examples > 0 and bf.stream_examples > 0
    st = feed.stats()
    assert type(st.freshness).__name__ == "FreshnessStats"
    assert type(st.freshness).__module__ == "repro_torch.streaming.session"
    assert st.freshness.batches_delivered == len(got)
    assert st.freshness.samples == rfeed.stats().freshness.samples
    assert st.client.full_batches == len(got) and st.client.h2d_bytes > 0
    assert sim.stream.pending_leases() == 0


def test_replay_in_flight_keeps_its_lease_across_the_flip():
    """The replay's first scan waits until the live leg has skipped every
    stream copy of the history as a duplicate, then the next day's
    compaction moves the one-day lookback past the replayed windows' start.
    The session holds the copies' leases while their replayed examples are
    in flight, so each replayed window is read from its logged generation:
    none is dropped as stale, and each example trains exactly once."""
    import threading
    import time

    ev = _m("repro_torch", "core.events")
    S = _m("repro_torch", "core.simulation")
    t = _m("repro_torch", "testing")
    sim = S.ProductionSim(S.SimConfig(
        stream=ev.StreamConfig(n_users=6, n_items=1_500, days=4,
                               events_per_user_day_mean=25.0, seed=9),
        stripe_len=16, requests_per_user_day=3, seed=9,
        lookback_ms=ev.MS_PER_DAY, pin_generations=True))
    sim.run_days(2)
    n_history = len(sim.examples)
    first = sum(1 for e in sim.examples if e.request_ts < ev.MS_PER_DAY)
    box, live_day_done = [], threading.Event()

    def next_day_under_the_replay():
        deadline = time.monotonic() + 30.0
        while not (box and box[0].session.backfill_stats.duplicates_skipped
                   == n_history) and time.monotonic() < deadline:
            time.sleep(0.01)
        sim.run_day(2)         # compaction at the end of day 1, live traffic
        live_day_done.set()

    plan = t.FaultPlan([t.FaultSpec("compaction_during_scan", 0)],
                       on_compact=next_day_under_the_replay)
    # windows of at most ~50 events fit L=64: each one checksum-validated
    spec = _spec("repro_torch", {"backfill_start_hour": 24,
                                 "backfill_end_hour": 47,
                                 "micro_batch_delay_s": 0.02}, seq_len=64,
                 consistency="audit", generations="pinned")
    feed = _m("repro_torch", "data").open_feed(spec, t.wrap_sim(sim, plan))
    box.append(feed)
    assert live_day_done.wait(60.0)
    sim.stream.close()
    batches = list(feed)
    feed.join()
    session = feed.session
    bf = session.backfill_stats
    assert plan.n_fired == 1 and bf.duplicates_skipped == n_history
    assert session.stale_dropped == 0 and session.abandoned == 0
    assert bf.warehouse_examples == n_history - first > 0
    assert bf.stream_examples == len(sim.examples) - n_history > 0
    assert _keys(batches) == _example_keys(sim.examples[first:])
    assert sim.stream.pending_leases() == 0
    ls = sim.immutable.lease_stats
    assert ls.acquired == ls.released and ls.generations_gc > 0


# ---------------------------------------------------------------------------
# kill and resume across the flip (tests/test_chaos.py:462)
# ---------------------------------------------------------------------------

def _trainer(pkg, ckpt_dir):
    if pkg == "repro":
        def loss_fn(p, b):
            score = jnp.sum(b["uih_item_id"] * p["w"], axis=1)
            return jnp.mean((score - b["label_click"]) ** 2)

        return JTrainer(loss_fn, {"w": jnp.zeros((16,), jnp.float32)},
                        JTrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=2,
                                       log_every=10**6))
    tl = _m(pkg, "train.train_loop")

    def loss_fn(p, b):
        ids = torch.as_tensor(np.asarray(b["uih_item_id"]))
        score = (ids.float() * p["w"]).sum(1)
        label = torch.as_tensor(np.asarray(b["label_click"])).float()
        return ((score - label) ** 2).mean()

    return tl.Trainer(loss_fn, to_parameter_dict({"w": torch.zeros(16)}),
                      tl.TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=2,
                                       log_every=10**6))


def _fit_recording(pkg, trainer, spec, sim, max_steps=None, **kw):
    recorded = []
    feed = _m(pkg, "data").open_feed(
        spec, sim, prep_fn=lambda b: (recorded.append(b), b)[1], **kw)
    trainer.fit(feed, max_steps=max_steps)
    feed.close(timeout=30.0)
    return recorded


def _kill_and_resume(pkg, root):
    sim, h1 = _sim(pkg, days=3, seed=8, live_days=1)
    day01_rows = sum(1 for e in sim.examples
                     if e.request_ts // MS_PER_HOUR <= h1)
    spec1 = _spec(pkg, {"backfill_end_hour": h1}, generations="pinned",
                  reshuffle_seed=3)
    t1 = _trainer(pkg, str(root / pkg))
    kill_at = day01_rows // spec1.batch_size + 2   # past the flip
    run1 = _fit_recording(pkg, t1, spec1, sim, max_steps=kill_at)
    assert t1.step == kill_at

    t2 = _trainer(pkg, str(root / pkg))
    assert t2.try_resume()
    feed_state = t2.ckpt.feed_state(t2.step)
    spec2 = _spec(pkg, {}, generations="pinned", reshuffle_seed=3)
    run2 = _fit_recording(pkg, t2, spec2, sim, resume_from=feed_state)
    trained = _keys(run1[:t2.step]) + _keys(run2)
    return sim, day01_rows, t2.step, feed_state, run1, trained


def test_kill_and_resume_across_the_flip_matches_reference(tmp_path):
    rsim, rrows, rstep, rstate, rrun1, _ = _kill_and_resume("repro", tmp_path)
    sim, rows, step, state, run1, trained = _kill_and_resume("repro_torch",
                                                             tmp_path)
    assert (rows, step) == (rrows, rstep)
    assert state == rstate                      # the same resume cursor
    assert state["kind"] == "stream"
    filt = state["stream"]["filters"][-1]
    assert filt["skip_rows"] == rows            # replay prefix fully trained
    assert filt["drop_hi"] > filt["drop_lo"] >= 0
    _assert_same_bytes(rrun1, run1)
    assert sorted(trained) == _example_keys(sim.examples)   # exactly once
    assert sim.stream.pending_leases() == 0
    consistency = _m("repro_torch", "core.consistency")
    mat = sim.materializer(validate_checksum=True, pin_generations=True)
    report = consistency.audit(sim.examples, sim.references, mat, sim.schema,
                               _spec("repro_torch", {}).tenant)
    assert report.clean and report.examples == len(sim.examples)


# ---------------------------------------------------------------------------
# the small DLRM-UIH trained from the stream
# ---------------------------------------------------------------------------

def _jax_prep(b, cfg):
    mask = b["uih_mask"]
    sources = (b["user_id"], b["cand_item_id"])
    return {
        "uih_item_id": (b["uih_item_id"] % cfg.item_vocab).astype(jnp.int32),
        "uih_action_type": (b["uih_action_type"] % 16).astype(jnp.int32),
        "uih_mask": mask,
        "cand_item_id": (b["cand_item_id"] % cfg.item_vocab).astype(
            jnp.int32),
        "sparse_ids": jnp.stack([sources[i % 2] % cfg.field_vocab
                                 for i in range(cfg.n_sparse)],
                                1).astype(jnp.int32),
        "dense": jnp.stack([mask.sum(1)] * cfg.n_dense, 1).astype(
            jnp.float32) / mask.shape[1],
        "label": b["label_click"].astype(jnp.float32),
    }


def test_dlrm_uih_losses_on_streamed_batches_match_reference():
    steps = 3
    j_cfg, t_cfg = j_cfgs.SMOKE, t_cfgs.SMOKE
    init = jax.jit(JR.init_dlrm_uih, static_argnums=1)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), j_cfg))
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=steps)
    hist = {}
    for pkg in PACKAGES:
        sim, h = _sim(pkg, days=3, live_days=1)
        spec = _spec(pkg, {"backfill_end_hour": h}, seq_len=j_cfg.seq_len,
                     generations="pinned", prefetch_depth=2, reshuffle_seed=3)
        if pkg == "repro":
            feed = _m(pkg, "data").open_feed(spec, sim)
            tr = JTrainer(lambda p, b: JR.dlrm_uih_loss(
                p, _jax_prep(b, j_cfg), j_cfg),
                jax.tree.map(jnp.asarray, tree),
                JTrainerConfig(opt=JAdamW(**opt), grad_accum=2))
        else:
            feed = _m(pkg, "data").open_feed(spec, sim, device="cpu")
            tr = _m(pkg, "train.train_loop").Trainer(
                lambda p, b: TR.dlrm_uih_loss(p, TR.dlrm_uih_prep(b, t_cfg),
                                              t_cfg),
                dlrm_uih_params_from_numpy(tree, t_cfg, "cpu"),
                _m(pkg, "train.train_loop").TrainerConfig(
                    opt=TAdamW(**opt), grad_accum=2))
        try:
            tr.fit(feed, max_steps=steps)
        finally:
            feed.close(timeout=30.0)
        hist[pkg] = tr.history
    got = [h["loss"] for h in hist["repro_torch"]]
    want = [h["loss"] for h in hist["repro"]]
    assert len(got) == len(want) == steps and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose([h["grad_norm"] for h in hist["repro_torch"]],
                               [h["grad_norm"] for h in hist["repro"]],
                               rtol=1e-3)
