"""The window's model FLOPs over what the card's dense bf16 peak could do
in its seconds, for the DeepSeek-V2 cell: FLOPs an example counted by hand
(``reference.deepseek_v2_flops``, the routed experts at the card's share of
pairs a token) times the examples trained, over the window's seconds times
989.4e12 (H100 SXM, NVIDIA's data sheet)."""
from bench.harness.manifest import find_cell, load_manifest
from bench.reference import deepseek_v2_flops

PEAK_FLOPS = 989.4e12


def read(r):
    if not r.examples or r.window_s <= 0:
        return None
    if r.cell not in {w["name"] for w in load_manifest()["workloads"]}:
        return None
    cell = find_cell(r.cell)
    cfg = cell.config
    if cfg.get("family") != "deepseek_v2":
        return None
    per = deepseek_v2_flops.per_example(cfg, cell.traffic["seq_len"],
                                        deepseek_v2_flops.share_pairs(cfg))
    return 100.0 * per * r.examples / (r.window_s * PEAK_FLOPS)
