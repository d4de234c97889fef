"""Render the dry-run and roofline tables and the hillclimb picks from the
port's dry-run results.

Usage:
  PYTHONPATH=src python -m benchmarks_torch.roofline_report [--mesh pod]
      [--results FILE [FILE ...]]

Port of ``benchmarks/roofline_report.py``. It departs from its reference
where the port's dry run (``repro_torch.launch.dryrun``) writes other keys:

  * it reads ``dryrun_results_torch.json`` at the repository root unless
    ``--results`` names one or more files, whose entries are merged (a
    later file's entry wins on a shared key), e.g. the per-arch files
    ``build/dryrun/dryrun_{pod,multipod}_<arch>_torch.json``;
  * ``--mesh`` also takes ``one`` (one card's program, ``--mesh one``);
  * the dry-run table's fourth column is ``trace``, the seconds the eager
    trace of the step took (``t_trace_s``), where the reference's is XLA's
    compile time; its sixth column is ``peak/chip``, the traced peak of
    live tensor bytes per chip (``memory.peak_bytes_per_chip``), where the
    reference's is XLA's temp buffer size;
  * its collectives are the trace's (``collectives.counts``): the port
    writes no calibration, since an eager trace already dispatches every
    loop iteration, so the roofline is ``roofline`` itself.

The roofline table and ``pick_hillclimb`` are the reference's, key for key.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Iterable, Optional

RESULTS = Path(__file__).resolve().parents[1] / "dryrun_results_torch.json"


def fmt_t(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def fmt_b(x: float) -> str:
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.2f}{unit}"
    return f"{x:.0f}B"


def read_results(paths: Optional[Iterable[Path]] = None) -> dict:
    """The entries of ``paths`` (default ``RESULTS``) merged by key."""
    res = {}
    for p in (paths or [RESULTS]):
        res.update(json.loads(Path(p).read_text()))
    return res


def load(mesh: str, paths: Optional[Iterable[Path]] = None):
    """[(entry, roofline)] of every ``ok`` entry on ``mesh``, by key."""
    rows = []
    for key, v in sorted(read_results(paths).items()):
        if not v.get("ok") or v["mesh"] != mesh:
            continue
        rows.append((v, v["roofline"]))
    return rows


def dryrun_table(mesh: str, paths: Optional[Iterable[Path]] = None) -> str:
    rows = load(mesh, paths)
    out = ["| arch | shape | kind | trace | HBM/chip (args) | peak/chip | "
           "collectives (per step) |",
           "|---|---|---|---|---|---|---|"]
    for v, r in rows:
        mem = v["memory"]
        cc = ", ".join(f"{k}x{c}" for k, c in
                       sorted(v["collectives"].get("counts", {}).items()))
        out.append(
            f"| {v['arch']} | {v['shape']} | {v['kind']} | "
            f"{v['t_trace_s']}s | {fmt_b(mem['args_logical_bytes_per_chip'])}"
            f" | {fmt_b(mem['peak_bytes_per_chip'])} | {cc} |")
    return "\n".join(out)


def roofline_table(mesh: str, paths: Optional[Iterable[Path]] = None) -> str:
    rows = load(mesh, paths)
    out = ["| arch | shape | t_compute | t_memory | t_collective | bottleneck |"
           " MODEL_FLOPS | useful ratio | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for v, r in rows:
        out.append(
            f"| {v['arch']} | {v['shape']} | {fmt_t(r['t_compute_s'])} | "
            f"{fmt_t(r['t_memory_s'])} | {fmt_t(r['t_collective_s'])} | "
            f"**{r['bottleneck']}** | {r['model_flops_total']:.3g} | "
            f"{r['model_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} |")
    return "\n".join(out)


def pick_hillclimb(mesh: str = "pod",
                   paths: Optional[Iterable[Path]] = None):
    """worst roofline fraction / most collective-bound / most paper-representative"""
    rows = load(mesh, paths)
    worst = min(rows, key=lambda x: x[1]["roofline_fraction"])
    coll = max(rows, key=lambda x: (x[1]["t_collective_s"]
                                    / max(x[1]["t_compute_s"]
                                          + x[1]["t_memory_s"], 1e-30)))
    paper = next((v, r) for v, r in rows
                 if v["arch"] == "dlrm-uih" and v["shape"] == "train_batch")
    return {"worst_fraction": f"{worst[0]['arch']}|{worst[0]['shape']}",
            "most_collective_bound": f"{coll[0]['arch']}|{coll[0]['shape']}",
            "paper_representative": f"{paper[0]['arch']}|{paper[0]['shape']}"}


def report(mesh: str, paths: Optional[Iterable[Path]] = None) -> str:
    """The three sections as ``main`` prints them."""
    return "\n".join([
        f"## Dry-run ({mesh})\n", dryrun_table(mesh, paths),
        f"\n## Roofline ({mesh})\n", roofline_table(mesh, paths),
        "\n## Hillclimb candidates\n",
        json.dumps(pick_hillclimb(mesh, paths), indent=1)])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "one"])
    ap.add_argument("--results", nargs="+", type=Path, default=None,
                    help="dry-run results files, merged (default: "
                         "dryrun_results_torch.json at the repository root)")
    args = ap.parse_args(argv)
    print(report(args.mesh, args.results))


if __name__ == "__main__":
    main()
