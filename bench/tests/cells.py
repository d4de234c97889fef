"""Cells at test sizes: the committed configurations' families and traffic
mixes, cut so that a whole run takes seconds on the CPU."""
from __future__ import annotations

import json

from bench.harness.manifest import BENCH, Cell, load_manifest

LIMITS = {"batch_mismatch": 0, "loss_gap": 0.01, "grad_gap": 0.01,
          "change_gap": 0.01}

CONFIGS = {
    "dlrm_uih": dict(family="dlrm_uih", name="dlrm_uih_smoke", seq_len=32,
                     d_seq=16, n_seq_layers=2, n_heads=2, n_dense=4,
                     n_sparse=2, embed_dim=8, item_vocab=1000,
                     field_vocab=100, top_mlp=[32, 16],
                     compute_dtype="bfloat16", remat=True, q_chunk=16),
    "dcn_v2": dict(family="dcn_v2", name="dcn_v2_smoke", n_dense=13,
                   n_sparse=5, embed_dim=4, n_cross_layers=2, mlp=[32, 16],
                   field_vocab=100, compute_dtype="bfloat16"),
}

# (family, traffic mix, seq_len, batch, users, days, events a day)
SMOKE = {
    "dlrm_uih.feed": ("dlrm_uih", "uih_l2048_b32", 32, 8, 8, 6, 10),
    "dcn_v2.feed": ("dcn_v2", "uih_l100_b1024", 16, 16, 16, 3, 10),
    "dcn_v2.ring": ("dcn_v2", "ring_l100_b1024", 16, 16, 16, 3, 10),
}


def smoke_cell(name: str, limits=None) -> Cell:
    fam, mix, seq_len, batch, users, days, events = SMOKE[name]
    traffic = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    traffic.update(name=mix, seq_len=seq_len, batch=batch, base_batch=4,
                   n_workers=2, max_rows_per_s=5000, check_window_span=6,
                   check_window_batches=2, ring_batches=4)
    traffic["sim"].update(n_users=users, days=days,
                          events_per_user_day_mean=events, n_items=1000,
                          lookback_days=5, retention_days=days + 1)
    m = load_manifest()
    return Cell(name, 1, dict(CONFIGS[fam]), traffic, dict(limits or LIMITS),
                m["end_to_end"], m["per_layer"])
