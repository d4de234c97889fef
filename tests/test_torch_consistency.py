"""The port's O2O audits, Fat Row baseline and chaos harness against the JAX
reference.

``audit``/``audit_streaming`` run over twin sims (one ``SimConfig``, same
seed) in both packages and must give equal reports, clean and under a scrub
that changes windows behind the examples' checksums. ``core.fatrow``'s cost
model agrees number for number, its Fat Row sims payload for payload.
``FaultPlan.seeded`` draws the reference's schedule, and the streaming fault
matrix (``tests/test_chaos.py:179``) holds the port's feed, under each fault
kind, byte-identical to its fault-free run and to the reference's.
"""
import dataclasses
import importlib

import numpy as np
import pytest

PACKAGES = ("repro", "repro_torch")


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------------------
# audit and audit_streaming
# ---------------------------------------------------------------------------

def _small_sim(pkg, mode="vlm", days=3, users=6, seed=0):
    """``tests/test_consistency.py``'s sim in ``pkg``."""
    ev = _m(pkg, "core.events")
    S = _m(pkg, "core.simulation")
    sim = S.ProductionSim(S.SimConfig(
        stream=ev.StreamConfig(n_users=users, n_items=2_000, days=days + 1,
                               events_per_user_day_mean=30.0, seed=seed),
        stripe_len=16, requests_per_user_day=3, mode=mode, seed=seed))
    sim.run_days(days)
    return sim


def _scrub(pkg, sim):
    """tests/test_consistency.py:115's drift: re-compact one user's history
    with a scrub that deletes their most common item."""
    target = next(e for e in sim.examples if e.version.seq_len > 4)
    uih = sim.materializer().materialize(target)
    item = int(np.bincount(uih["item_id"]).argmax())
    scrub = _m(pkg, "storage.compaction").make_scrub(deleted_items=[item])
    sim.run_compaction(sim.immutable.watermark(target.user_id), scrub=scrub)


def _audits(pkg, drift):
    c = _m(pkg, "core.consistency")
    mat_err = _m(pkg, "core.materialize").ChecksumMismatch
    sim = _small_sim(pkg, days=2, seed=11)
    if drift:
        _scrub(pkg, sim)
    mat = sim.materializer(validate_checksum=False)
    pairs = list(zip(sim.examples, sim.references))
    whole = c.audit(sim.examples, sim.references, mat, sim.schema)
    batched = c.audit(sim.examples, sim.references, mat, sim.schema,
                      batched=True)
    mismatched = [e.request_id for e, r in pairs
                  if c.audit([e], [r], mat, sim.schema).o2o_mismatches]
    checked = sim.materializer(validate_checksum=True)
    flagged = []
    for e in sim.examples:
        try:
            checked.materialize(e)
        except mat_err:
            flagged.append(e.request_id)
    st = _m(pkg, "streaming")
    sim.stream.close()
    src = st.StreamingSource(sim.stream, st.MicroBatchConfig(max_examples=7))
    refs = {e.request_id: r for e, r in pairs}
    streamed = c.audit_streaming(src.micro_batches(), refs, mat, sim.schema,
                                 ack=src.ack)
    return {"audit": dataclasses.asdict(whole),
            "batched": dataclasses.asdict(batched),
            "streaming": dataclasses.asdict(streamed),
            "mismatched": mismatched, "flagged": flagged,
            "pending": sim.stream.pending_leases()}


@pytest.mark.parametrize("drift", [False, True], ids=["clean", "drift"])
def test_audit_reports_match_reference(drift):
    want, got = (_audits(pkg, drift) for pkg in PACKAGES)
    assert got == want
    n = got["audit"]["examples"]
    assert n > 0 and got["streaming"]["examples"] == n
    assert got["pending"] == 0
    for kind in ("audit", "batched", "streaming"):
        assert got[kind]["leaked_events"] == 0
        assert got[kind]["o2o_mismatches"] == len(got["mismatched"])
    if drift:   # the scrub changed windows, and both packages flag them
        assert got["mismatched"] and got["flagged"]
        assert set(got["mismatched"]) <= set(got["flagged"])
    else:
        assert got["mismatched"] == got["flagged"] == []


def test_consistency_helpers_match_reference():
    ref, port = (_m(pkg, "core.consistency") for pkg in PACKAGES)
    sim = _small_sim("repro_torch", days=1, seed=4)
    tenants = _m("repro_torch", "core.projection").table1_tenants(
        long_len=64, mid_len=16, short_len=4)
    for exm, uih in zip(sim.examples[:20], sim.references[:20]):
        for ts in (exm.request_ts, exm.request_ts - 60_000, 0):
            assert (port.future_leakage_count(uih, ts)
                    == ref.future_leakage_count(uih, ts))
        for proj in (None, *tenants.values()):
            got = port.project_reference(uih, proj, sim.schema)
            want = ref.project_reference(uih, proj, sim.schema)
            assert port.batches_equal(got, want) and ref.batches_equal(want,
                                                                       got)
    assert port.AuditReport(examples=3).clean
    assert not port.AuditReport(o2o_mismatches=1).clean


# ---------------------------------------------------------------------------
# the Fat Row baseline and cost model
# ---------------------------------------------------------------------------

def test_fatrow_cost_model_matches_reference():
    ref, port = (_m(pkg, "core.fatrow") for pkg in PACKAGES)
    models = [(ref.WorkloadModel(), port.WorkloadModel()),
              (ref.WorkloadModel(requests_per_user_day=6.0, replay_factor=1.0),
               port.WorkloadModel(requests_per_user_day=6.0,
                                  replay_factor=1.0))]
    for rm, pm in models:
        assert dataclasses.asdict(pm) == dataclasses.asdict(rm)
        for seq_len in (1, 64, 512, 2048, 8192, 65_536, 1 << 20):
            for fn in ("fat_row_cost", "vlm_cost"):
                got = getattr(port, fn)(seq_len, pm)
                want = getattr(ref, fn)(seq_len, rm)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert (got.ratio, got.data_services) == (want.ratio,
                                                          want.data_services)
        for threshold in (0.25, 0.75, 2.0):
            assert (port.fat_row_wall(threshold, pm)
                    == ref.fat_row_wall(threshold, rm))
    assert port.fat_row_wall() > 1


def test_fatrow_baseline_payloads_match_reference():
    """Fat Row sims in both packages log the same examples and materialize
    the same UIH; in the port the Fat Row baseline equals VLM and the
    inference-time reference (tests/test_consistency.py:73,80)."""
    ref, fat, vlm = (_small_sim("repro", "fatrow", seed=7),
                     _small_sim("repro_torch", "fatrow", seed=7),
                     _small_sim("repro_torch", "vlm", seed=7))
    c = _m("repro_torch", "core.consistency")
    assert len(fat.examples) == len(ref.examples) == len(vlm.examples) > 0
    m_ref, m_fat, m_vlm = (s.materializer() for s in (ref, fat, vlm))
    for er, ef, ev in zip(ref.examples, fat.examples, vlm.examples):
        assert ef.payload_bytes(fat.schema) == er.payload_bytes(ref.schema)
        assert ef.request_ts == er.request_ts == ev.request_ts
        got = m_fat.materialize(ef)
        want = m_ref.materialize(er)
        assert list(got) == list(want)
        assert all(got[k].tobytes() == want[k].tobytes() for k in got)
        assert c.batches_equal(got, m_vlm.materialize(ev))
    report = c.audit(fat.examples, fat.references, m_fat, fat.schema)
    assert report.clean and report.examples == len(fat.examples)


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
def test_seeded_fault_plan_matches_reference(seed):
    rates = {"worker_crash": 0.2, "scan_ioerror": 0.1,
             "stream_disconnect": 0.15, "compaction_during_scan": 0.05}
    plans = [_m(pkg, "testing").FaultPlan.seeded(seed, rates, 60)
             for pkg in PACKAGES]
    ticks = [{k: sorted(v) for k, v in p._ticks.items()} for p in plans]
    assert ticks[0] == ticks[1]
    assert any(ticks[1].values())
    fired = []
    for p in plans:
        for _ in range(60):
            p.scan_tick()
            p.consume_tick()
        fired.append([(f.kind, f.at) for f in p.fired])
    assert fired[0] == fired[1] and len(fired[1]) == plans[1].n_fired > 0
    assert set(_m("repro_torch", "testing").ALL_KINDS) == set(
        _m("repro", "testing").ALL_KINDS)


# ---------------------------------------------------------------------------
# the streaming fault matrix (tests/test_chaos.py:179)
# ---------------------------------------------------------------------------

def _faults(pkg):
    FaultSpec = _m(pkg, "testing").FaultSpec
    return {
        "worker_crash": [FaultSpec("worker_crash", 1),
                         FaultSpec("worker_crash", 3)],
        "scan_ioerror": [FaultSpec("scan_ioerror", 0),
                         FaultSpec("scan_ioerror", 4)],
        "decode_corruption": [FaultSpec("decode_corruption", 2)],
        "compaction_during_scan": [FaultSpec("compaction_during_scan", 1),
                                   FaultSpec("compaction_during_scan", 3)],
        "node_unavailable": [FaultSpec("node_unavailable", 1),
                             FaultSpec("node_unavailable", 4)],
        "node_flap": [FaultSpec("node_flap", 1, node=1, duration=2),
                      FaultSpec("node_flap", 4, node=3, duration=2)],
        "node_slow": [FaultSpec("node_slow", 2, node=0, duration=3,
                                factor=6.0)],
        "stream_disconnect": [FaultSpec("stream_disconnect", 1),
                              FaultSpec("stream_disconnect", 7)],
    }


STREAM_FAULTS = sorted(_faults("repro"))
NODE_KINDS = {"node_unavailable": (4, 1), "node_flap": (4, 2),
              "node_slow": (4, 2)}
TRAITS = ("timestamp", "item_id", "action_type")


def _stream_sim(pkg, nodes, replication):
    ev = _m(pkg, "core.events")
    S = _m(pkg, "core.simulation")
    sim = S.ProductionSim(S.SimConfig(
        stream=ev.StreamConfig(n_users=6, n_items=1_500, days=4,
                               events_per_user_day_mean=25.0, seed=9),
        stripe_len=16, requests_per_user_day=3, seed=9, pin_generations=True,
        n_store_nodes=nodes, replication_factor=replication))
    sim.run_days(2)
    sim.stream.close()   # sealed backlog: the feed drains it and ends
    return sim


def _stream_spec(pkg):
    data = _m(pkg, "data")
    return data.DatasetSpec(
        tenant=_m(pkg, "core.projection").TenantProjection(
            "t", 16, ("core",), traits_per_group={"core": TRAITS}),
        source=data.StreamSource(micro_batch_delay_s=5.0),
        features=_m(pkg, "dpp.featurize").FeatureSpec(
            seq_len=16, uih_traits=TRAITS[1:]),
        batch_size=8, base_batch_size=4, n_workers=2, prefetch_depth=0,
        window_cache_size=0, consistency="audit", generations="pinned")


def _drain(pkg, sim):
    feed = _m(pkg, "data").open_feed(_stream_spec(pkg), sim)
    out = list(feed)
    feed.join()
    return feed, out


def _assert_same_bytes(want, got):
    assert len(want) == len(got) > 0
    for x, y in zip(want, got):
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()


@pytest.mark.parametrize("kind", STREAM_FAULTS)
def test_streaming_fault_matrix_matches_reference(kind):
    nodes, repl = NODE_KINDS.get(kind, (0, 1))
    _, want = _drain("repro", _stream_sim("repro", nodes, repl))
    _, clean = _drain("repro_torch", _stream_sim("repro_torch", nodes, repl))
    _assert_same_bytes(want, clean)

    t = _m("repro_torch", "testing")
    sim = _stream_sim("repro_torch", nodes, repl)
    specs = _faults("repro_torch")[kind]
    plan = t.FaultPlan(specs, on_compact=lambda: sim.run_compaction(
        sim.compaction_watermark, evict=False))
    fsim = t.wrap_sim(sim, plan)
    feed, chaos = _drain("repro_torch", fsim)
    assert plan.n_fired == len(specs)
    fsim.immutable.settle_node_state()
    _assert_same_bytes(clean, chaos)
    assert sim.stream.pending_leases() == 0
    assert sim.immutable.leased_generations() == {}
    if kind == "stream_disconnect":
        assert feed.session.source.stats.reconnects == 2
    if kind in ("worker_crash", "scan_ioerror", "decode_corruption",
                "node_unavailable"):
        assert feed.stats().workers.worker_restarts >= len(specs)
    c = _m("repro_torch", "core.consistency")
    mat = sim.materializer(validate_checksum=True, pin_generations=True)
    report = c.audit(sim.examples, sim.references, mat, sim.schema,
                     _stream_spec("repro_torch").tenant)
    assert report.clean and report.examples == len(sim.examples)
