"""Figure 2 reproduction: data-supporting-service vs GPU cost as sequence
length scales, under Fat Row vs versioned late materialization; plus the
'Fat Row Wall' (ratio > 0.75, §5.2).

Port of ``benchmarks/fig2_cost_wall.py`` over the port's copy of
``core.fatrow``; no departure. It is analytic: every derived value is
fixed.
"""
from __future__ import annotations

from typing import List

from benchmarks_torch.common import BenchResult
from repro_torch.core.fatrow import WorkloadModel, fat_row_cost, fat_row_wall, vlm_cost


def run(quick: bool = False) -> List[BenchResult]:
    m = WorkloadModel()
    out: List[BenchResult] = []
    seqs = [256, 4096, 65_536] if quick \
        else [256, 1024, 4096, 16_384, 65_536, 262_144]
    for seq in seqs:
        f = fat_row_cost(seq, m)
        v = vlm_cost(seq, m)
        out.append(BenchResult(
            f"fig2/seq_{seq}", 0.0,
            {
                "fatrow_data_over_gpu": round(f.ratio, 3),
                "vlm_data_over_gpu": round(v.ratio, 3),
                "fatrow_data_cost": f"{f.data_services:.3g}",
                "vlm_data_cost": f"{v.data_services:.3g}",
            },
        ))
    wall = fat_row_wall(0.75, m)
    vlm_wall = None
    seq = 256
    while seq <= (1 << 22):
        if vlm_cost(seq, m).ratio > 0.75:
            vlm_wall = seq
            break
        seq *= 2
    out.append(BenchResult(
        "fig2/fat_row_wall", 0.0,
        {"fatrow_wall_seq_len": wall,
         "paper_wall_approx": 4096,
         "vlm_wall_seq_len": vlm_wall or f">{1 << 22}"},
    ))
    return out


if __name__ == "__main__":
    for r in run():
        print(r.csv())
