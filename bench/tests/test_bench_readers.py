"""The metric readers and the trace arithmetic on synthetic inputs."""
from __future__ import annotations

import statistics

import pytest

from bench.harness import check as C
from bench.harness import trace as T
from bench.harness.driver import Readings
from bench.harness.manifest import reader
from bench.reference import densify_bytes


def readings(**kw):
    r = Readings(cell="c", batch=32, window_s=10.0, window_start=100.0,
                 step_ends=[100.0 + 0.25 * i for i in range(1, 41)],
                 examples=40 * 32, setup_s=30.0, peak_bytes=2**31,
                 flops_per_example=2e10)
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_union_merges_overlapping_streams():
    iv = [(0, 10, "a"), (5, 15, "b"), (20, 30, "c"), (30, 31, "d")]
    assert T.union(iv) == [(0, 15), (20, 31)]
    assert T.busy_ns(iv, 0, 40) == 26
    assert T.busy_ns(iv, 8, 25) == 12


def test_idle_gaps_named_by_host_phase_and_next_op():
    iv = [(0, 10, "k1"), (50, 60, "k2"), (61, 70, "k3")]
    phases = [(10, 40, "waiting"), (40, 70, "compute")]
    gaps = T.idle_gaps(iv, 0, 100, phases)
    assert gaps[0] == ["waiting / before k2", 40 / 1e9]
    assert gaps[1][1] == 30 / 1e9 and "window end" in gaps[1][0]


def test_top_ops_sums_by_name():
    iv = [(0, 10, "a"), (10, 15, "b"), (20, 30, "a")]
    assert T.top_ops(iv) == [["a", 20 / 1e9], ["b", 5 / 1e9]]


def test_counter_growth():
    a = {"starved_s": 1.0, "batches": 3}
    b = {"starved_s": 2.5, "batches": 10}
    assert C.counter_growth(a, b) == {"starved_s": 1.5, "batches": 7}


def test_end_to_end_readers():
    r = readings()
    assert reader("train_examples_per_s").read(r) == pytest.approx(128.0)
    assert reader("step_ms_p90").read(r) == pytest.approx(250.0)
    assert reader("peak_mem_gib").read(r) == 2.0
    assert reader("setup_s").read(r) == 30.0


def test_p90_over_all_intervals():
    ends = [100.0 + x for x in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
                                0.9, 1.0, 3.0)]
    r = readings(step_ends=ends)
    gaps = [100.0] * 10 + [2000.0]
    want = statistics.quantiles(gaps, n=10, method="inclusive")[8]
    assert reader("step_ms_p90").read(r) == pytest.approx(want)
    assert reader("step_ms_p90").read(readings(step_ends=ends[:5])) is None


def test_per_layer_readers():
    r = readings(feed={"starved_s": 0.5, "batches": 40, "h2d_bytes": 40e6,
                       "h2d_s": 0.8, "dpp_busy_s": 2.0, "dpp_examples": 1000},
                 grad_ms=[100.0, 200.0], adamw_ms=[60.0, 70.0],
                 densify={"least_s": 1e-6, "device_s": 4e-6, "launches": 3},
                 trace={"busy_s": 7.5, "window_s": 10.0})
    assert reader("feed_wait_share").read(r) == pytest.approx(5.0)
    assert reader("dpp_busy_us_per_example").read(r) == pytest.approx(2000.0)
    assert reader("h2d_bytes_per_example").read(r) == pytest.approx(31250.0)
    assert reader("h2d_ms_per_batch").read(r) == pytest.approx(20.0)
    assert reader("densify_roofline").read(r) == pytest.approx(25.0)
    assert reader("grad_ms").read(r) == 150.0
    assert reader("adamw_ms").read(r) == 65.0
    assert reader("device_idle_share").read(r) == pytest.approx(25.0)
    assert reader("step_mfu").read(r) == pytest.approx(
        100 * 2e10 * 1280 / (10.0 * 989.4e12))


@pytest.mark.parametrize("name", ["feed_wait_share", "dpp_busy_us_per_example",
                                  "h2d_bytes_per_example", "h2d_ms_per_batch",
                                  "densify_roofline", "grad_ms", "adamw_ms",
                                  "device_idle_share"])
def test_readers_give_nothing_without_input(name):
    assert reader(name).read(readings()) is None


def test_densify_bytes_by_hand():
    b, L = 3, 8
    payload = {"_seq_len": L, "uih_len": [2, 8, 0],
               "_arena_item_id": [0] * 10, "_arena_timestamp":
               __import__("numpy").zeros(10, "int64")}
    n, launches = densify_bytes.of_payload(payload)
    want = 10 * 2 * 4 + 4 * 4 + 3 * 8 * 2 * 4 + 3 * 8 + 3 * 8 * 8
    assert (n, launches) == (want, 1)
    payload["uih_len"] = [0, 0, 0]
    assert densify_bytes.of_payload(payload) == (0, 0)
