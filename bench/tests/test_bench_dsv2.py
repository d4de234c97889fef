"""The DeepSeek-V2-Lite cell: its files found by name, its configuration
against the published one, its reference on the meta device, its two
readers, and a whole run at a test size on the CPU (sound: correct; the
control and a planted fault: not)."""
from __future__ import annotations

import json

import pytest
import torch

import bench.harness.manifest as manifest
from bench import run as bench_run
from bench.harness.driver import Readings
from bench.harness.manifest import BENCH, Cell, find_cell, load_manifest, reader
from bench.models import deepseek_v2 as adapter
from bench.reference import deepseek_v2 as ref
from bench.reference import deepseek_v2_flops, flops
from bench.reference.precision import CONTROL

CELL = "dsv2_lite.feed.l2048"
# the published config.json's keys (its nested rope_scaling whole)
PUBLISHED = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
    "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
    "topk_method": "greedy", "v_head_dim": 128, "vocab_size": 102400}


def test_cell_files_found_by_name():
    cell = find_cell(CELL)
    assert cell.chips == 1 and cell.config["family"] == "deepseek_v2"
    assert {m["name"] for m in cell.per_layer} == {"expert_gemm_roofline",
                                                   "lm_step_mfu"}
    assert {m["name"] for m in cell.end_to_end} == {
        "train_examples_per_s", "peak_mem_gib", "setup_s"}
    # no loss_gap: the third step's loss is chaotic on some seeds, and the
    # program's own repeats spread as far as the float8 control's least
    assert set(cell.limits) == {"batch_mismatch", "grad_gap", "change_gap"}
    assert cell.traffic["mode"] == "feed" and cell.traffic["seq_len"] == 2048
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reader(m["name"]).read)


def test_configuration_keeps_the_published_model():
    entry = {c["name"]: c for c in load_manifest()["configs"]}[
        "deepseek_v2_lite_ep8"]
    cfg = find_cell(CELL).config
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == ["n_routed_experts"]
    changed = {k for k, v in PUBLISHED.items() if cfg[k] != v}
    assert changed == {"n_routed_experts"}
    assert cfg["n_routed_experts"] == 8
    dep = cfg["deployment"]
    assert dep["router_experts"] == PUBLISHED["n_routed_experts"]
    assert dep["expert_parallel_cards"] * cfg["n_routed_experts"] == 64
    pc = adapter.port_config(cfg)
    assert pc.param_count() == 3_110_989_312
    assert pc.moe.n_experts == 64 and pc.moe.held == 8 and pc.moe.top_k == 6


def test_reference_runs_on_the_meta_device():
    cfg = find_cell(CELL).config
    counted = flops.per_example(ref, cfg, 8, 2048)
    assert counted == deepseek_v2_flops.per_example(cfg, 2048, 8)
    share = deepseek_v2_flops.per_example(
        cfg, 2048, deepseek_v2_flops.share_pairs(cfg))
    assert deepseek_v2_flops.share_pairs(cfg) == 0.75
    assert 0 < share < counted


def _readings(**kw):
    r = Readings(cell=CELL, batch=16, window_s=50.0, window_start=0.0,
                 step_ends=[3.0 * i for i in range(1, 18)], examples=17 * 16)
    for k, v in kw.items():
        setattr(r, k, v)
    return r


@pytest.mark.parametrize("name", ["expert_gemm_roofline", "lm_step_mfu"])
def test_readers_give_nothing_without_input(name):
    assert reader(name).read(_readings(examples=0, step_ends=[])) is None
    assert reader(name).read(_readings(cell="c", examples=0)) is None


def test_expert_gemm_roofline(monkeypatch):
    from repro_torch.kernels.grouped_gemm import ops

    read = reader("expert_gemm_roofline").read
    trace = {"device_ops": [["void (anonymous namespace)::grouped_gemm_"
                             "kernel(Args, int)", 2.0], ["other", 9.0]]}
    assert read(_readings()) is None                     # no trace
    monkeypatch.setattr(ops.grouped_gemm, "launches", 0, raising=False)
    assert read(_readings(trace=trace)) is None           # no launch
    monkeypatch.setattr(ops.grouped_gemm, "launches", 60)
    monkeypatch.setattr(ops, "flops", lambda: 4e14)
    assert read(_readings(trace={"device_ops": [["other", 1.0]]})) is None
    want = 100 * 4e14 * 17 / 20 / (2.0 * 989.4e12)
    assert read(_readings(trace=trace)) == pytest.approx(want)


def test_lm_step_mfu():
    cfg = find_cell(CELL).config
    per = deepseek_v2_flops.per_example(cfg, 2048, 0.75)
    got = reader("lm_step_mfu").read(_readings())
    assert got == pytest.approx(100 * per * 272 / (50.0 * 989.4e12))
    assert reader("lm_step_mfu").read(_readings(
        cell="dlrm_uih.feed.l2048")) is None


SMOKE_CONFIG = {
    **PUBLISHED, "name": "dsv2_smoke", "family": "deepseek_v2",
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "intermediate_size": 96, "moe_intermediate_size": 32,
    "n_routed_experts": 4, "n_shared_experts": 1, "num_experts_per_tok": 3,
    "num_hidden_layers": 3, "vocab_size": 1000, "aux_loss_alpha": 0.001,
    "compute_dtype": "bfloat16", "remat": True, "q_chunk": 16,
    "loss_chunk": 16, "deployment": {"router_experts": 16, "first_held": 4}}
LIMITS = {"batch_mismatch": 0, "grad_gap": 0.05, "change_gap": 0.05}


def _run(monkeypatch, faults=None, program_loss=None):
    traffic = json.loads((BENCH / "traffic" / "uih_items_l2048_b16.json"
                          ).read_text())
    traffic.update(name="uih_items_l2048_b16", seq_len=32, batch=8,
                   base_batch=4, max_rows_per_s=5000, check_window_span=6,
                   check_window_batches=2)
    traffic["sim"].update(n_users=8, days=6, events_per_user_day_mean=10,
                          n_items=1000, lookback_days=5, retention_days=7)
    m = load_manifest()
    cell = Cell(CELL, 1, dict(SMOKE_CONFIG), traffic, dict(LIMITS),
                m["end_to_end"], m["per_layer"])
    monkeypatch.setattr(manifest, "find_cell", lambda _: cell)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    if program_loss is not None:
        monkeypatch.setattr(adapter, "program_loss", program_loss)
    argv = ["--workload", CELL, "--seed", "2147483659", "--seconds", "1",
            "--trace", "0"]
    return bench_run.main(argv, device="cpu", faults=faults)


def test_sound_run_is_correct(monkeypatch):
    line = _run(monkeypatch)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def test_control_is_not_correct(monkeypatch):
    line = _run(monkeypatch, program_loss=lambda cfg: lambda p, b: ref.loss(
        p, ref.prep(b, cfg), cfg, CONTROL))
    assert line["correct"] is False


def test_altered_token_is_not_correct(monkeypatch):
    def alter(batch):
        lane = batch["uih_item_id"].clone()
        lane[int(batch["uih_mask"].sum(1).argmax()), -1] += 1
        return dict(batch, uih_item_id=lane)

    line = _run(monkeypatch, faults={"batch": alter})
    assert line["checks"]["batch_mismatch"]["value"] > 0
