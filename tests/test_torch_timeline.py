"""Thread phase spans on the profiler's clock: the trainer's step phases, the
transfer thread's handover phases and the DPP workers' CPU time, recorded
through ``repro_torch.obs`` when telemetry is on and not at all when off."""
import json
import re
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import events as ev
from repro_torch.core.projection import TenantProjection
from repro_torch.core.simulation import ProductionSim, SimConfig
from repro_torch.data import DatasetSpec, SimSource, open_feed
from repro_torch.dpp.featurize import FeatureSpec
from repro_torch.obs import Telemetry
from repro_torch.obs import timeline as TL
from repro_torch.obs.spans import PHASE_CAPACITY, PhaseClock, SpanTracker
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import Trainer, TrainerConfig

STEPS = 6
BATCH = 8
TRAIN = ("train.feed_wait", "train.grads", "train.optimizer",
         "train.readback")
# a batch's handover: the pull, a staging and a copy's (or a kernel's)
# dispatch for each array, the wait on the side stream, the offer
H2D = re.compile(r"h2d\.pull (h2d\.stage (h2d\.launch )+)+"
                 r"h2d\.event_wait h2d\.offer")


def _cpu_tick():
    """The thread CPU clock's step: a microsecond or less on most hosts, a
    scheduler tick (10 ms) where the kernel's clock runs on jiffies."""
    steps, c = [], time.thread_time_ns()
    while len(steps) < 3:
        n = time.thread_time_ns()
        if n != c:
            steps.append(n - c)
            c = n
    return max(steps)


def _slack(wall_ns, tick):
    """The most a phase's cpu_ns may read: its wall time, plus one step of
    the CPU clock, plus what the two clocks' rates may differ by."""
    return wall_ns + tick + 10_000 + wall_ns // 1000


def test_phase_spans_share_the_profilers_clock():
    tr = SpanTracker()
    ph = PhaseClock(tr)
    with record_function("warm"):       # the profiler's first region is slow
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            ph.start()
            with record_function(f"probe{i}"):
                time.sleep(0.005)
            ph.lap("probe")
            ph.commit(i)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe")}
    starts, ends = [], []
    for p in tr.phases:
        e = events[f"probe{p.id}"]
        starts.append(abs(e.start_ns() - p.t0_ns))
        ends.append(abs(e.start_ns() + e.duration_ns() - p.t1_ns))
    # the best of five regions: a preempted one says nothing of the clock
    assert min(starts) < 200_000 and min(ends) < 200_000, (starts, ends)


class _Event:
    """A CUDA timing event's protocol over a counter."""
    now = 0.0

    def __init__(self):
        self.done = False
        self.t = None

    def record(self):
        _Event.now += 1.0
        self.t = _Event.now

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_marks_land_on_their_phase_and_resolve_lazily():
    tr = SpanTracker()
    made = []
    ph = PhaseClock(tr, event=lambda: made.append(_Event()) or made[-1])
    ph.start()
    ph.lap("a")
    ph.mark()                 # the origin: no interval
    ph.mark("copy")           # inside phase b
    ph.mark("densify")
    ph.lap("b")
    ph.lap("c")
    a, b, c = ph.commit(7)
    assert [s.id for s in (a, b, c)] == [7, 7, 7]
    assert a.t1_ns == b.t0_ns and b.t1_ns == c.t0_ns
    made[1].done = True       # copy done, densify still running
    tr.resolve()
    assert b.device_ms == {"copy": 1.0}
    assert a.device_ms is None and c.device_ms is None
    rows = tr.timeline()      # waits for the rest
    assert rows[1]["device_ms"] == {"copy": 1.0, "densify": 1.0}
    assert "device_ms" not in rows[0]


def test_phase_ring_is_bounded_and_counts_what_it_drops():
    tr = SpanTracker()
    for i in range(PHASE_CAPACITY + 2):
        tr.phase("p", "t", i, i + 1, 0, i)
    assert len(tr.phases) == PHASE_CAPACITY
    assert tr.phases[0].id == 2 and tr.phases[-1].id == PHASE_CAPACITY + 1
    assert tr.phases_dropped == 2
    assert tr.lifecycle_counts()["phases_dropped"] == 2


def test_device_marks_resolve_on_commit_without_a_trainer():
    """A transfer thread's marks resolve as its own cycles commit, so the
    queue of unresolved marks stays as short as the device lags, read by a
    trainer with telemetry or not."""
    tr = SpanTracker()
    live = []

    def event():
        # the device runs one event behind the host: recording one
        # completes every event recorded before it
        for e in live:
            e.done = True
        live.append(_Event())
        return live[-1]

    ph = PhaseClock(tr, event=event)
    most = 0
    for batch in range(500):
        ph.start()
        for _ in range(3):             # three arrays' copies
            ph.lap("h2d.stage")
            ph.mark()
            ph.mark("copy")
            ph.lap("h2d.launch")
        ph.commit(batch)
        most = max(most, len(tr._pending))
    assert most <= 3
    assert all(p.device_ms == {"copy": 1.0} for p in list(tr.phases)[:-3]
               if p.name == "h2d.launch")


def _feed(tel):
    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=8, n_items=2_000, days=4,
                               events_per_user_day_mean=30.0, seed=7),
        stripe_len=16, requests_per_user_day=4, seed=7))
    sim.run_days(3, capture_reference=False)
    traits = ("timestamp", "item_id", "action_type")
    spec = DatasetSpec(
        tenant=TenantProjection("t", seq_len=16, feature_groups=("core",),
                                traits_per_group={"core": traits}),
        source=SimSource(min_rows=(STEPS + 4) * BATCH),
        batch_size=BATCH, base_batch_size=4, prefetch_depth=2,
        n_workers=2, ordered=True, device_materialize=True,
        reshuffle_seed=3, telemetry=tel,
        features=FeatureSpec(seq_len=16, uih_traits=traits[1:]
                             + ("timestamp",), candidate_fields=("item_id",),
                             label_fields=("click",)))
    return open_feed(spec, sim, device="cpu")


def _loss(params, batch):
    x = torch.stack([batch["uih_item_id"].float().mean(1),
                     batch["uih_action_type"].float().mean(1)], 1) / 1000.0
    y = batch["label_click"].float()
    return ((x @ params["w"] + params["b"] - y) ** 2).mean()


def _fit(tel):
    params = {"w": torch.full((2,), 0.5, requires_grad=True),
              "b": torch.zeros((), requires_grad=True)}
    trainer = Trainer(_loss, params, TrainerConfig(
        opt=AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=STEPS),
        grad_accum=2, log_every=10**9))
    feed = _feed(tel)
    try:
        trainer.fit(feed, max_steps=STEPS)
        workers = feed.pool.merged_worker_stats()
    finally:
        feed.close(timeout=30.0)
    return [h["loss"] for h in trainer.history], workers


def test_fit_with_telemetry_files_every_threads_phases(tmp_path):
    tel = Telemetry(sample_every=1)
    losses, workers = _fit(tel)
    assert len(losses) == STEPS
    spans = tel.spans
    assert spans.phases_dropped == 0
    phases = list(spans.phases)
    tick = _cpu_tick()
    for p in phases:
        assert 0 <= p.cpu_ns <= _slack(p.t1_ns - p.t0_ns, tick), p.to_dict()
        assert p.t0_ns <= p.t1_ns

    train = [p for p in phases if p.name.startswith("train.")]
    assert [p.id for p in train] == [s for s in range(1, STEPS + 1)
                                     for _ in TRAIN]
    for s in range(STEPS):
        step = train[4 * s:4 * s + 4]
        assert tuple(p.name for p in step) == TRAIN
        assert len({p.thread for p in step}) == 1
        for x, y in zip(step, step[1:]):
            assert x.t1_ns <= y.t0_ns
    hist = tel.registry.histogram("repro_train_step_seconds")
    assert hist.count == STEPS

    h2d = [p for p in phases if p.name.startswith("h2d.")]
    assert h2d and {p.thread for p in h2d} == {"dpp-prefetch"}
    by_batch = {}
    for p in h2d:
        by_batch.setdefault(p.id, []).append(p.name)
    assert len(by_batch) >= STEPS
    for names in by_batch.values():
        assert H2D.fullmatch(" ".join(names)), names

    dpp = [p for p in phases if p.name in ("dpp.scan", "dpp.featurize")]
    assert dpp and all(p.thread.startswith("dpp-worker-") for p in dpp)
    assert {p.thread for p in phases if p.name == "dpp.place"} == {
        "dpp-placer"}
    # every item's lookup and featurize, sampled or not
    assert len(dpp) == 2 * workers.base_batches
    assert workers.cpu_time_s == pytest.approx(
        sum(p.cpu_ns for p in dpp) / 1e9)
    assert 0 < workers.cpu_time_s <= (workers.busy_time_s
                                      + len(dpp) * (tick + 10_000) / 1e9)

    run = tel.write_run_dir(tmp_path / "run")
    rows = [json.loads(line) for line in
            (run / "timeline.jsonl").read_text().splitlines()]
    assert rows == [p.to_dict() for p in phases]


def test_fit_without_telemetry_reads_no_cpu_clock_and_trains_alike(
        monkeypatch):
    on, _ = _fit(Telemetry(sample_every=1))
    calls = {"thread_time_ns": 0, "phase": 0}
    thread_time_ns, phase = time.thread_time_ns, SpanTracker.phase

    def counted_thread_time():
        calls["thread_time_ns"] += 1
        return thread_time_ns()

    def counted_phase(self, *args, **kwargs):
        calls["phase"] += 1
        return phase(self, *args, **kwargs)

    monkeypatch.setattr(time, "thread_time_ns", counted_thread_time)
    monkeypatch.setattr(SpanTracker, "phase", counted_phase)
    off, workers = _fit(None)
    assert calls == {"thread_time_ns": 0, "phase": 0}
    assert workers.cpu_time_s == 0.0
    assert off == on            # bit for bit


def test_run_step_outside_fit_files_the_three_step_phases():
    tel = Telemetry()
    params = {"w": torch.full((2,), 0.5, requires_grad=True),
              "b": torch.zeros((), requires_grad=True)}
    trainer = Trainer(_loss, params, TrainerConfig(telemetry=tel))
    batch = {"uih_item_id": torch.arange(32).reshape(4, 8),
             "uih_action_type": torch.ones(4, 8, dtype=torch.int64),
             "label_click": torch.tensor([0, 1, 0, 1])}
    for _ in range(2):
        trainer.run_step(batch)
    assert [(p.name, p.id) for p in tel.spans.phases] == [
        (n, s) for s in (1, 2) for n in TRAIN[1:]]


def _p(name, t0, t1, cpu=0, thread="MainThread", id=1, dev=None):
    out = {"name": name, "thread": thread, "t0_ns": t0, "t1_ns": t1,
           "cpu_ns": cpu, "id": id}
    if dev is not None:
        out["device_ms"] = dev
    return out


def test_timeline_arithmetic_by_hand():
    # window [0, 100); the device runs [10, 30) and [25, 40) and [90, 120),
    # so it idles in [0, 10), [40, 90)
    device = [(25, 40, "k1"), (10, 30, "k0"), (90, 120, "k2")]
    assert TL.idle_intervals(device, 0, 100) == [(0, 10), (40, 90)]
    assert TL.idle_intervals([(-5, 3), (2, 8)], 0, 10) == [(8, 10)]
    phases = [
        _p("train.feed_wait", 0, 12, cpu=2),
        _p("train.grads", 12, 50, cpu=19),       # idle inside: [40, 50)
        _p("train.optimizer", 50, 70, cpu=10),   # idle inside: [50, 70)
        _p("train.readback", 70, 95, cpu=5),
        _p("train.grads", 60, 80, thread="other"),
        _p("h2d.launch", 5, 9, thread="dpp-prefetch", id=4,
           dev={"copy": 0.5}),
        _p("h2d.launch", 9, 11, thread="dpp-prefetch", id=4,
           dev={"densify": 0.25}),
        _p("h2d.launch", 20, 24, thread="dpp-prefetch", id=5,
           dev={"copy": 1.5}),
    ]
    grads_opt = {"train.grads", "train.optimizer"}
    assert TL.idle_share(phases, device, (0, 100), grads_opt,
                         "MainThread") == pytest.approx(30.0)
    assert TL.idle_share(phases, device, (0, 100), {"train.feed_wait"},
                         "MainThread") == pytest.approx(10.0)
    # every thread's grads: [12, 50) and [60, 80) merge with [50, 70)
    assert TL.idle_share(phases, device, (0, 100),
                         grads_opt) == pytest.approx(40.0)
    assert TL.cpu_share(phases, grads_opt, "MainThread") == pytest.approx(
        100.0 * 29 / 58)
    assert TL.cpu_share(phases, {"nothing"}) is None
    assert TL.device_ms_per_id(phases, "h2d.", ("copy", "densify")) == (
        pytest.approx(1.125))
    assert TL.device_ms_per_id(phases, "dpp.", ("copy",)) is None
    s = TL.summary(phases)
    assert s["dpp-prefetch"]["h2d.launch"] == {
        "n": 3, "wall_ms": pytest.approx(10e-6 / 3),
        "cpu_ms": 0.0, "device_ms": {"copy": pytest.approx(2.0 / 3),
                                     "densify": pytest.approx(0.25 / 3)}}
    assert s["MainThread"]["train.grads"]["n"] == 1


def test_timeline_cli_renders_a_run_dir(tmp_path, capsys):
    tel = Telemetry()
    ph = PhaseClock(tel.spans)
    for step in (1, 2):
        ph.start()
        ph.lap("train.grads")
        ph.lap("train.optimizer")
        ph.commit(step)
    run = tel.write_run_dir(tmp_path / "run")
    assert len(TL.load(run)) == 4
    assert TL.main([str(run)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split()[:2] == ["thread", "phase"]
    rows = {tuple(line.split()[1:3]) for line in out[1:]}
    assert rows == {("train.grads", "2"), ("train.optimizer", "2")}
    assert TL.main([]) == 2
