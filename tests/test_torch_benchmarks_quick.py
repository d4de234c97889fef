"""The port's benchmarks (``benchmarks_torch/``) at their ``--quick`` configs
on the CPU: every module in ``benchmarks_torch/run.py``'s ``MODULES`` runs
and yields well-formed ``BenchResult``s with the reference's names and
``derived`` keys, and the CPU route launches none of the four kernels
(their wrappers run the plain versions on CPU tensors). The derived values
that the seeds fix (counts, ratios, byte counts, NE from the same initial
parameters) are held against the reference's on the same inputs; the
timings are not compared."""
import sys
from pathlib import Path

import numpy as np
import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:  # make `benchmarks*.*` importable
    sys.path.insert(0, str(REPO_ROOT))

from benchmarks import run as ref_run  # noqa: E402
from benchmarks_torch import run as bench_run  # noqa: E402
from benchmarks_torch.common import BenchResult  # noqa: E402
from repro_torch.kernels.delta_decode import ops as dd  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb  # noqa: E402
from repro_torch.kernels.fused import ops as fu  # noqa: E402
from repro_torch.kernels.jagged import ops as jg  # noqa: E402

NAMES = [m.rsplit(".", 1)[1] for m in bench_run.MODULES]
WRAPPERS = (fu.fused_densify, eb.embedding_bag, jg.jagged_to_padded,
            dd.delta_decode)
# the reference's quick bench_device_mat asserts its host-time claim over a
# median of 3 rounds in a fixed order, which goes either way at that size
# (ROADMAP queue 3); its names and keys are compared from the port's run
# against the reference module's source, and its byte counts against the
# reference's byte-count code (test_device_mat_byte_counts_...)
COMPARED = [n for n in NAMES if n != "bench_device_mat"]
# {module: {result: derived keys whose values the seeds fix}}; fig4's NE is
# fixed once both sides train from the same initial parameters. Keys that
# come from timing stay out, also where they are counts: rebatch's best
# base batch, prefetch's waste, failover's breaker opens, failovers and
# hedged reads (a 50 ms breaker reset and a latency quantile), and
# streaming's generation flips, pinned windows, lease GCs and stream lag
# (a churn thread races the session)
FIG2 = ("fatrow_data_over_gpu", "vlm_data_over_gpu", "fatrow_data_cost",
        "vlm_data_cost")
MULTITENANT = ("tenants", "co_bytes", "solo_bytes_sum", "bytes_saved_pct",
               "co_stripe_decodes", "solo_stripe_decodes",
               "share_bytes_saved_vs_solo", "share_union_overfetch",
               "co_scan_windows", "outputs_identical")
FIXED = {
    "fig2_cost_wall": {
        **{f"fig2/seq_{n}": FIG2 for n in (256, 4096, 65_536)},
        "fig2/fat_row_wall": ("fatrow_wall_seq_len", "paper_wall_approx",
                              "vlm_wall_seq_len")},
    "table1_system_efficiency": {
        "table1/primary_write_bandwidth": ("ours_pct", "paper_pct",
                                           "vlm_bytes", "fat_bytes"),
        # the latency is modelled from the byte and scan counters
        "table1/model_c": ("read_bw_pct", "paper_read_pct",
                           "lookup_stream_pct_of_baseline_read",
                           "paper_lookup_stream",
                           "lookup_batch_pct_of_baseline_read",
                           "paper_lookup_batch", "latency_delta_pct",
                           "paper_latency_pct")},
    "bench_prefetch": {"prefetch/pipelined_throughput": ("paper_pct",)},
    "bench_affinity": {
        "affinity/lookup_bandwidth": ("ours_pct", "paper_pct",
                                      "arrival_bytes", "affine_bytes",
                                      "arrival_fanout", "affine_fanout"),
        "affinity/worker_throughput": ("paper_pct",)},
    "bench_scan_plan": {
        "scan_plan/io_work": ("per_example_seeks", "planned_seeks",
                              "per_example_decodes", "planned_decodes",
                              "dedup_hits", "decode_cache_hits",
                              "parallel_shards", "fewer_seeks",
                              "fewer_decodes"),
        "scan_plan/throughput": ("per_example_bytes", "planned_bytes")},
    "bench_rebatch": {"rebatch/base_batch_tuning": ("paper_pct",)},
    "bench_multitenant": {f"multitenant/n{n}_tenants": MULTITENANT
                          for n in (1, 2, 3)},
    "bench_sharded_store": {
        "sharded_store/max_node_load": (
            "hash_max_mean", "length_aware_max_mean", "hash_stored_max_mean",
            "length_aware_stored_max_mean", "hash_node_bytes",
            "length_aware_node_bytes")},
    "bench_failover": {
        "failover/throughput_one_node_down": ("r1_down_rows_per_s",
                                              "r1_down_unavailable_rate"),
        "failover/hedged_read_tail_latency": ("slow_factor",),
        # recover() resets the breaker: one scan reaches the primary
        "failover/recovery_time_to_healthy": ("generations_replayed",
                                              "rereplicated_bytes",
                                              "scans_to_healthy")},
    "bench_streaming": {
        "streaming_sustained": ("rows", "window_failures"),
        "streaming_handoff": ("warehouse_examples", "stream_examples",
                              "duplicates_skipped", "watermark",
                              "hours_replayed", "empty_hours",
                              "exactly_once")},
    "bench_chaos": {
        "chaos_clean": ("rows",),
        "chaos_faulty_1pct": ("rows", "faults_injected", "worker_restarts",
                              "items_requeued"),
        "chaos_equivalence": ("byte_identical",)},
    "bench_kernels": {
        "codec/encode": ("compression_ratio",),
        "kernel/delta_decode": ("exact_match", "elements"),
        "kernel/jagged_to_padded": ("rows", "max_len", "d"),
        "kernel/embedding_bag": ("bags", "bag_len", "d")},
    "bench_feed": {
        "feed/featurize_rebatch": ("byte_identical", "target_x"),
        "feed/telemetry_overhead": ("sample_every", "target_pct")},
    "bench_serve": {
        "serve/healthy": ("cold_requests", "cache_hit_rate", "batches",
                          "byte_identical"),
        "serve/sharded_faults": ("faults_settled", "degraded_scans")},
    "fig4_ne_scaling": {
        "fig4/ne_seq_4": ("ne",), "fig4/ne_seq_16": ("ne",),
        "fig4/scaling": ("ne_gain_short_to_long_pct",
                         "monotone_improvements", "paper"),
        "fig4/vlm_vs_fatrow_parity": ("seq_len", "ne_vlm", "ne_fatrow",
                                      "abs_diff", "paper")},
}
# fig4's NE after 30 AdamW steps: float32 reduction order differs between
# the packages, so each NE is held at the rtol of tests/test_torch_slice.py;
# the gain 100 * (1 - b / a) then moves by at most 200 * rtol percentage
# points, plus its rounding to 2 decimals
NE_RTOL = 1e-3
NE_TOL = {"ne": {"rel": NE_RTOL}, "ne_vlm": {"rel": NE_RTOL},
          "ne_fatrow": {"rel": NE_RTOL},
          "ne_gain_short_to_long_pct": {"abs": 200 * NE_RTOL + 0.01}}


def _quick(name: str):
    return bench_run.run_module(f"benchmarks_torch.{name}", quick=True,
                                device="cpu")


def test_modules_list_complete():
    listed = {m.rsplit(".", 1)[1] for m in bench_run.MODULES}
    on_disk = {p.stem for p in (REPO_ROOT / "benchmarks_torch").glob("*.py")
               if p.stem not in ("run", "common", "__init__",
                                 "roofline_report")}
    assert on_disk == listed, on_disk ^ listed
    assert bench_run.MODULES == [
        "benchmarks_torch." + m.removeprefix("benchmarks.")
        for m in ref_run.MODULES]


@pytest.mark.parametrize("name", NAMES)
def test_benchmark_quick(name):
    before = [w.launches for w in WRAPPERS]
    results = _quick(name)
    assert [w.launches for w in WRAPPERS] == before    # CPU: plain versions
    assert isinstance(results, list) and results, name
    for r in results:
        assert isinstance(r, BenchResult)
        assert r.name and isinstance(r.derived, dict)
        r.csv()  # the CSV line must render
    if name == "bench_kernels":
        by = {r.name: r for r in results}
        assert by["kernel/delta_decode"].derived["exact_match"] is True
    if name == "bench_device_mat":
        src = (REPO_ROOT / "benchmarks" / "bench_device_mat.py").read_text()
        (r,) = results
        assert r.name == "device_mat/late_materialization"
        assert all(f'"{k}"' in src for k in r.derived)
        assert r.derived["h2d_compact_bytes_per_batch"] < \
            r.derived["h2d_dense_bytes_per_batch"]


def _reference_init(monkeypatch):
    """Make the port's ``init_dlrm_uih`` draw the reference's parameters
    (its ``PRNGKey(seed)``), carried over through ``interop``."""
    import jax
    import jax.numpy as jnp

    from repro.models import recsys as JR
    from repro_torch.interop import dlrm_uih_params_from_numpy
    from repro_torch.models import recsys as R

    def init(cfg, seed, device):
        fields = {f: getattr(cfg, f)
                  for f in JR.DLRMUIHConfig.__dataclass_fields__
                  if f != "compute_dtype" and hasattr(cfg, f)}
        j_cfg = JR.DLRMUIHConfig(**fields, compute_dtype=jnp.float32)
        tree = jax.tree.map(np.asarray,
                            JR.init_dlrm_uih(jax.random.PRNGKey(seed), j_cfg))
        return dlrm_uih_params_from_numpy(tree, cfg, device)

    monkeypatch.setattr(R, "init_dlrm_uih", init)


@pytest.mark.parametrize("name", COMPARED)
def test_names_and_derived_keys_equal_the_reference(name, monkeypatch):
    if name == "fig4_ne_scaling":
        _reference_init(monkeypatch)
    got = _quick(name)
    want = ref_run.run_module(f"benchmarks.{name}", quick=True)
    assert [r.name for r in got] == [r.name for r in want]
    for g, w in zip(got, want):
        assert list(g.derived) == list(w.derived), g.name
        for k in FIXED[name].get(g.name, ()):
            gv, wv = g.derived[k], w.derived[k]
            if k in NE_TOL:
                assert gv == pytest.approx(wv, **NE_TOL[k]), (g.name, k)
            else:
                assert gv == wv, (g.name, k, gv, wv)
    if name == "bench_kernels":
        assert all(r.derived["exact_match"] is True for r in (got + want)
                   if "exact_match" in r.derived)


def test_device_mat_byte_counts_equal_the_reference():
    """``bench_device_mat`` at its quick shapes (both modules': 12 base
    batches of 8 rows, L=1024, mean length 32, 16-row full batches): the
    port's synthetic features equal the reference's, and its H2D byte
    counts and fill equal what the reference's client,
    ``jagged_batch_nbytes`` and ``materialization_roofline`` give, and its
    roofline times what the port's model gives at the reference's shape."""
    from benchmarks import bench_device_mat as ref
    from benchmarks_torch import bench_device_mat as port
    from repro.dpp.device_mat import jagged_batch_nbytes
    from repro.roofline.analysis import materialization_roofline

    n_batches, rows, seq_len, mean_len, full_b = 12, 8, 1024, 32, 16
    want_feats = ref._synth_features(n_batches, rows, seq_len, mean_len)
    got_feats = port._synth_features(n_batches, rows, seq_len, mean_len)
    for w, g in zip(want_feats, got_feats, strict=True):
        np.testing.assert_array_equal(g.offsets, w.offsets)
        for part in ("values", "scalars"):
            got, want = getattr(g, part), getattr(w, part)
            assert list(got) == list(want), part
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    dense, _ = ref._client_path(want_feats, full_b, emit_jagged=False)
    jag, _ = ref._client_path(want_feats, full_b, emit_jagged=True)
    n = len(dense)
    dense_bytes = sum(v.nbytes for d in dense for v in d.values())
    jag_bytes = sum(jagged_batch_nbytes(j) for j in jag)
    arena_rows = sum(int(np.sum(np.minimum(j["uih_len"], seq_len)))
                     for j in jag)
    shape = dict(batch=full_b, seq_len=seq_len, n_traits=3,
                 arena_rows=arena_rows // n, itemsize=4)
    roof = materialization_roofline(**shape)
    # the port's model holds the H100's link and HBM rates, the reference's
    # a TPU's: its times are taken from the port's model at the reference's
    # shape and arena rows
    h100 = port.materialization_roofline(**shape)
    want = {"h2d_dense_bytes_per_batch": dense_bytes // n,
            "h2d_compact_bytes_per_batch": jag_bytes // n,
            "h2d_savings_pct": round(100.0 * (1 - jag_bytes / dense_bytes), 1),
            "fill_pct": round(100.0 * roof.fill, 1),
            "roofline_t_host_us": round(1e6 * h100.t_host_path, 2),
            "roofline_t_device_us": round(1e6 * h100.t_device_path, 2),
            "roofline_device_wins": h100.device_wins}
    (r,) = _quick("bench_device_mat")
    assert {k: r.derived[k] for k in want} == want


def test_standard_sim_matches_the_reference():
    from benchmarks.common import standard_sim as ref_sim
    from benchmarks_torch.common import standard_sim

    got, want = (f("vlm", users=4, days=2, req_per_day=2, events_mean=20.0)
                 for f in (standard_sim, ref_sim))
    key = [(e.request_id, e.user_id, e.request_ts) for e in want.examples]
    assert key and [(e.request_id, e.user_id, e.request_ts)
                    for e in got.examples] == key
    assert got.warehouse.hours() == want.warehouse.hours()


def test_run_main_refuses_cuda_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench_run.main(["--quick", "bench_kernels"])


def test_run_main_quick_on_the_cpu_writes_no_results(capsys):
    results = REPO_ROOT / "benchmarks_torch" / "results.json"
    before = results.stat().st_mtime_ns if results.exists() else None
    bench_run.main(["--quick", "--device", "cpu", "bench_kernels"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# device: cpu (cpu)"
    assert out[1] == "name,us_per_call,derived"
    assert any(ln.startswith("kernel/delta_decode,") for ln in out)
    assert (results.stat().st_mtime_ns if results.exists() else None) \
        == before


def test_scan_plan_planned_path_is_byte_identical():
    """``bench_scan_plan``'s two paths over its quick batches: the port's
    planned ``materialize_batch`` (decode cache on) gives, example for
    example, the bytes of its per-example ``materialize`` and of the
    reference's per-example path on the reference's sim of the same seed."""
    from benchmarks import bench_scan_plan as ref
    from benchmarks_torch import bench_scan_plan as port
    from repro.storage import columnar as ref_columnar
    from repro_torch.storage import columnar

    sims = {}
    for mod, cols in ((ref, ref_columnar), (port, columnar)):
        sim = mod.standard_sim("vlm", users=8, days=2, req_per_day=4)
        sim.immutable.decode_cache = None
        sims[mod] = (sim, mod._user_bucketed_batches(sim, base=16))
    (r_sim, r_batches), (p_sim, p_batches) = sims[ref], sims[port]
    want = [r_sim.materializer(validate_checksum=False).materialize(
        e, ref.TENANT) for b in r_batches for e in b]
    p_mat = p_sim.materializer(validate_checksum=False)
    solo = [p_mat.materialize(e, port.TENANT) for b in p_batches for e in b]
    p_sim.immutable.decode_cache = columnar.StripeDecodeCache(256)
    planned = [x for b in p_batches
               for x in p_sim.materializer(validate_checksum=False)
               .materialize_batch(b, port.TENANT)]
    assert len(planned) == len(solo) == len(want) > 0
    for got in (planned, solo):
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_failover_shares_the_sharded_store_population():
    from benchmarks_torch import bench_failover, bench_sharded_store
    from benchmarks.bench_sharded_store import _population as ref_population

    assert bench_failover.LATENCY is bench_sharded_store.LATENCY
    assert bench_failover._population is bench_sharded_store._population
    got, want = bench_sharded_store._population(6, 20), ref_population(6, 20)
    assert list(got) == list(want)
    for uid in want:
        assert list(got[uid]) == list(want[uid])
        for k in want[uid]:
            np.testing.assert_array_equal(got[uid][k], want[uid][k])


def test_bench_chaos_refuses_cuda_without_a_card(monkeypatch):
    import torch

    from benchmarks_torch import bench_chaos

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench_chaos.run(quick=True)
