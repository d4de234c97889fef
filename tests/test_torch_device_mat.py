"""The port's device handover (``repro_torch.dpp.device_mat``/``prefetch``) and
its copied host data plane, against the JAX reference.

* ``DeviceMaterializer`` (plain version on the CPU) equals ``densify_host``
  exactly: keys, order, host dtypes, bytes (timestamps exact int64);
* it equals the JAX ``DeviceMaterializer`` after jax's int32 wrap;
* all-empty batches and drift traits (own offsets) included;
* the copied host plane produces byte-identical payloads to ``repro``'s
  from the same ``ProductionSim`` seed.
"""
import threading

import numpy as np
import pytest

from repro.core import events as j_ev
from repro.core.simulation import ProductionSim as JSim, SimConfig as JSimCfg
from repro.core.versioning import TrainingExample as JExample
from repro.dpp import device_mat as j_dm
from repro.dpp.client import RebatchingClient as JClient
from repro.dpp.featurize import FeatureSpec as JSpec
from repro.dpp.featurize import featurize_jagged as j_featurize
from repro_torch.core import events as t_ev
from repro_torch.core.simulation import ProductionSim as TSim
from repro_torch.core.simulation import SimConfig as TSimCfg
from repro_torch.core.versioning import TrainingExample as TExample
from repro_torch.dpp import device_mat as t_dm
from repro_torch.dpp.client import RebatchingClient as TClient
from repro_torch.dpp.featurize import FeatureSpec as TSpec
from repro_torch.dpp.featurize import featurize_jagged as t_featurize
from repro_torch.dpp.prefetch import DevicePrefetcher

TRAITS = ("item_id", "action", "flag", "score", "timestamp")
SEQ_LEN = 7
TS_BASE = 3_000_000_000     # > 2^31: the exact-int64 decode path


def _synth(rng, b, drop_flag_at=(), empty=False):
    """Raw (example fields, uih) rows with mixed trait dtypes, timestamps past
    2^31, and the ``flag`` trait missing from some rows (schema drift)."""
    rows = []
    for i in range(b):
        n = 0 if empty else int(rng.integers(0, 3 * SEQ_LEN))
        u = {"timestamp": TS_BASE + np.sort(
            rng.integers(0, 10_000, n)).astype(np.int64)}
        for t, dt in (("item_id", np.int64), ("action", np.int32),
                      ("flag", np.int8), ("score", np.float32)):
            u[t] = rng.integers(0, 100, n).astype(dt)
        if i in drop_flag_at:
            u.pop("flag")
        ex = dict(request_id=i, user_id=int(rng.integers(0, 50)),
                  request_ts=TS_BASE + 10_000 + i, label_ts=0,
                  candidate={"item_id": int(rng.integers(0, 100))},
                  labels={"click": float(rng.random() < 0.3)})
        rows.append((ex, u))
    return rows


def _chunks(seed, n=5, empty=False):
    rng = np.random.default_rng(seed)
    return [_synth(rng, int(rng.integers(1, 11)),
                   drop_flag_at=(1,) if k == 1 else (), empty=empty)
            for k in range(n)]


def _payloads(chunks, port, emit_jagged=True, seed=3):
    """Full batches from each package's featurizer + rebatching client."""
    Example, Spec, featurize, Client = (
        (TExample, TSpec, t_featurize, TClient) if port
        else (JExample, JSpec, j_featurize, JClient))
    spec = Spec(seq_len=SEQ_LEN, uih_traits=TRAITS,
                candidate_fields=("item_id",), label_fields=("click",))
    c = Client(8, buffer_batches=1024, shuffle_seed=seed,
               emit_jagged=emit_jagged)
    for rows in chunks:
        exs = [Example(**ex) for ex, _ in rows]
        c.put_jagged(featurize(exs, [u for _, u in rows], spec))
    c.close()
    return list(c)


def _assert_host_exact(got, want):
    assert list(got) == list(want)
    for k in want:
        g = np.asarray(got[k])
        assert g.dtype == want[k].dtype, k
        assert g.shape == want[k].shape, k
        np.testing.assert_array_equal(g.view(np.uint8), want[k].view(np.uint8),
                                      err_msg=k)


def _assert_reference_after_wrap(got, want):
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_array_equal(np.asarray(got[k]).astype(w.dtype), w,
                                      err_msg=k)


@pytest.mark.parametrize("empty", [False, True])
def test_materializer_equals_densify_host_and_reference(empty):
    chunks = _chunks(21, empty=empty)
    ported = _payloads(chunks, port=True)
    reference = _payloads(chunks, port=False)
    assert len(ported) == len(reference) > 0
    t_mat = t_dm.DeviceMaterializer(device="cpu")
    j_mat = j_dm.DeviceMaterializer()
    for p, r in zip(ported, reference):
        assert t_dm.is_jagged_batch(p)
        got = t_mat(p)
        assert t_mat.last_h2d_bytes > 0
        assert all(v.device.type == "cpu" for v in got.values())
        _assert_host_exact(got, t_dm.densify_host(p))
        _assert_reference_after_wrap(got, j_mat(r))
    if not empty:
        # the drift row forced a trait with its own offsets somewhere, and
        # timestamps stayed int64 through the compact payload
        assert any("_offsets_flag" in p for p in ported)
        assert all(p["_arena_timestamp"].dtype == np.int64 for p in ported)
        assert any(t_dm.densify_host(p)["uih_timestamp"].max() > 2**31
                   for p in ported)


def test_jagged_payloads_densify_to_the_dense_client_batches():
    """emit_jagged=True carries exactly the dense path's rows."""
    chunks = _chunks(20, n=6)
    dense = _payloads(chunks, port=True, emit_jagged=False, seed=5)
    jag = _payloads(chunks, port=True, emit_jagged=True, seed=5)
    assert len(dense) == len(jag) > 0
    for d, j in zip(dense, jag):
        _assert_host_exact(t_dm.densify_host(j), d)
        assert t_dm.jagged_batch_nbytes(j) == j_dm.jagged_batch_nbytes(j)


def test_prefetcher_materializes_on_its_thread_and_counts_h2d_bytes():
    chunks = _chunks(23)
    dense = _payloads(chunks, port=True, emit_jagged=False, seed=1)
    dense_bytes = sum(v.nbytes for d in dense for v in d.values())
    client = TClient(8, buffer_batches=1024, shuffle_seed=1, emit_jagged=True)
    spec = TSpec(seq_len=SEQ_LEN, uih_traits=TRAITS,
                 candidate_fields=("item_id",), label_fields=("click",))
    for rows in chunks:
        client.put_jagged(t_featurize([TExample(**ex) for ex, _ in rows],
                                      [u for _, u in rows], spec))
    client.close()
    pf = DevicePrefetcher(client, depth=2, device="cpu",
                          materialize=t_dm.DeviceMaterializer(device="cpu"))
    got = list(pf)
    assert len(got) == len(dense)
    for g, d in zip(got, dense):
        _assert_host_exact(g, d)
    assert 0 < client.stats.h2d_bytes < dense_bytes
    assert client.stats.full_batches == len(dense)


def _sim(ev, Sim, Cfg, seed):
    sim = Sim(Cfg(stream=ev.StreamConfig(n_users=6, n_items=1_500, days=4,
                                         events_per_user_day_mean=25.0,
                                         seed=seed),
                  stripe_len=16, requests_per_user_day=3, seed=seed))
    sim.run_days(2, capture_reference=False)
    return sim


def _sim_payloads(port, seed):
    if port:
        from repro_torch.core.projection import TenantProjection
        from repro_torch.data import compile as comp
        from repro_torch.data.spec import DatasetSpec, SimSource
        from repro_torch.dpp.elastic import DPPWorkerPool
        sim, Client, Spec = _sim(t_ev, TSim, TSimCfg, seed), TClient, TSpec
    else:
        from repro.core.projection import TenantProjection
        from repro.data import compile as comp
        from repro.data.spec import DatasetSpec, SimSource
        from repro.dpp.elastic import DPPWorkerPool
        sim, Client, Spec = _sim(j_ev, JSim, JSimCfg, seed), JClient, JSpec
    tenant = TenantProjection(
        "dlrm-uih", seq_len=16, feature_groups=("core",),
        traits_per_group={"core": ("timestamp", "item_id", "action_type")})
    spec = DatasetSpec(
        tenant=tenant, source=SimSource(), batch_size=8, base_batch_size=4,
        n_workers=1, features=Spec(
            seq_len=16, uih_traits=("item_id", "action_type", "timestamp"),
            candidate_fields=("item_id",), label_fields=("click",)))
    client = Client(spec.batch_size, buffer_batches=64, shuffle_seed=0,
                    emit_jagged=True)
    pool = DPPWorkerPool.from_plan(comp.compile_worker_plan(spec, sim), client,
                                   n_workers=1, ordered=True)
    pool.start(comp._batch_items(spec, sim))
    # pool.join() closes the client (its end-of-stream); the consumer drains
    # meanwhile, or workers parked on the client's slots never finish
    joiner = threading.Thread(target=pool.join, daemon=True)
    joiner.start()
    out = list(client)
    joiner.join(timeout=30)
    assert not joiner.is_alive()
    return out


def test_copied_host_plane_payloads_are_byte_identical():
    ported = _sim_payloads(port=True, seed=4)
    reference = _sim_payloads(port=False, seed=4)
    assert len(ported) == len(reference) > 0
    for p, r in zip(ported, reference):
        assert list(p) == list(r)
        for k in r:
            a, b = np.asarray(p[k]), np.asarray(r[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
