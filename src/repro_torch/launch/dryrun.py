"""Multi-pod dry run of the port over a fake production mesh.

Port of ``repro.launch.dryrun``. Where the reference
lowers and compiles each (architecture x input shape x mesh) cell for 512
host devices and reads XLA's analyses, eager PyTorch traces rank 0's
program: the process joins PyTorch's ``fake`` process group at the mesh's
rank count (256 for the 16x16 pod, 512 for the 2x16x16 multi-pod), builds
the FULL cell, makes its arguments as fake tensors of rank 0's block shapes
(``FakeTensorMode``: nothing is allocated at full size) and runs the step
once under ``roofline.step_counts`` and ``MemTracker``. It records, per
rank: the logical bytes of the step's inputs under their placements, the
peak of live tensor bytes during the step, the counted FLOPs and bytes (the
eager program's traffic), the collectives and their ring-model link bytes,
the H100 roofline, and the floor of the step's math (compulsory bytes and
model FLOPs, ``roofline.analysis.compulsory_floor``).

The reference also has a calibration pass that re-lowers each cell with
its scans unrolled, because XLA's cost analysis counts a loop body once. An
eager step dispatches every iteration of its loops, so this trace is
already the calibrated count and the port has no second pass.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dlrm-uih --shape serve_p99 --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh one
``--mesh one`` traces the cells on a 1x1 mesh: one card's program, whose
peak is what ``chip_smoke.py`` reckons before it runs a cell at full size.
Every mesh traces all 44 cells (the 24 LM/GNN zoo cells and the 20 recsys
ones), 88 on the two production meshes: the zoo's cells as their
rank-local tensor-, vocabulary- and expert-parallel programs.
Results accumulate in dryrun_results_torch.json at the repository root (one
entry per cell; idempotent), or in ``--out``; the reference's
``dryrun_results.json`` is never touched.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.steps import S, build_cell
from repro_torch.roofline.analysis import compulsory_floor, from_compiled
from repro_torch.roofline.step_counts import count_step
from repro_torch.train.optimizer import AdamWState
from repro_torch.tree import tree_leaves, tree_map

RESULTS = Path(__file__).resolve().parents[3] / "dryrun_results_torch.json"


def mesh_named(mesh_name: str):
    """``pod`` (16x16), ``multipod`` (2x16x16) or ``one`` (1x1)."""
    if mesh_name == "one":
        return make_test_mesh(1, "cpu")
    return make_production_mesh(multi_pod=(mesh_name == "multipod"))


def _local_args(cell, mesh):
    """Rank 0's block of every argument as a fresh tensor (call under
    ``FakeTensorMode``); float parameters of a train cell require grad."""
    out = []
    for i, (arg, sh) in enumerate(zip(cell.args_spec, cell.in_shardings)):
        def make(leaf: S, spec):
            shape = SH.local_shape(leaf.shape, spec, mesh)
            t = torch.empty(shape, dtype=leaf.dtype)
            if i == 0 and cell.kind == "train":
                t.requires_grad_(True)
            return t

        if isinstance(arg, AdamWState):
            out.append(AdamWState(step=make(arg.step, sh.step),
                                  m=tree_map(make, arg.m, sh.m),
                                  v=tree_map(make, arg.v, sh.v)))
        else:
            out.append(tree_map(make, arg, sh))
    return tuple(out)


def trace_cell(cell, mesh) -> dict:
    """Counts and memory of one step of ``cell`` on rank 0's fake blocks."""
    with FakeTensorMode():
        args = _local_args(cell, mesh)
        tracker = MemTracker()
        tracker.track_external(*[t for t in tree_leaves(args)])
        with tracker:
            counts = count_step(cell.step_fn, *args)
    peak = tracker.get_tracker_snapshot("peak")
    return {"counts": counts,
            "peak_bytes": int(max((d["Total"] for d in peak.values()),
                                  default=0))}


def archs_on(mesh_name: str, archs=None):
    """The archs whose cells the dry run traces on ``mesh_name`` (of
    ``archs``, default every registered one): every family on every
    mesh."""
    return list(list_archs() if archs is None else archs)


def run_cell(arch_id: str, shape_name: str, mesh_name: str) -> dict:
    spec = get_arch(arch_id)
    mesh = mesh_named(mesh_name)
    chips = mesh.size()
    t0 = time.time()
    cell = build_cell(spec, shape_name, mesh, use_full=True)
    t_build = time.time() - t0
    t0 = time.time()
    traced = trace_cell(cell, mesh)
    t_trace = time.time() - t0
    counts = traced["counts"]
    coll = counts.collectives
    roof = from_compiled(arch_id, shape_name, mesh_name, chips, counts.cost,
                         coll.link_bytes, coll.counts, cell.model_flops)
    return {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "kind": cell.kind, "chips": chips,
        "t_build_s": round(t_build, 2), "t_trace_s": round(t_trace, 2),
        "memory": {"args_logical_bytes_per_chip": _logical_bytes(cell, mesh),
                   "peak_bytes_per_chip": traced["peak_bytes"]},
        "cost": counts.cost,
        "collectives": coll.to_dict(),
        "model_flops": cell.model_flops,
        "meta": {k: v for k, v in cell.meta.items() if k != "cfg"}
        | {"cfg": cell.meta["cfg"].name},
        "roofline": roof.to_dict(),
        "floor": compulsory_floor(counts.compulsory_bytes, cell.model_flops,
                                  chips),
        "ok": True,
    }


def _logical_bytes(cell, mesh) -> int:
    """Per-chip bytes of all step inputs under their placements."""
    chips = mesh.size()
    total = 0

    def leaf_bytes(leaf: S, spec) -> int:
        shard = 1
        for e in (spec if spec is not None else ()):
            for ax in (e if isinstance(e, tuple) else (e,)):
                if ax is not None:
                    shard *= mesh.size(mesh.mesh_dim_names.index(ax))
        return leaf.nbytes // max(shard, 1)

    for args, shs in zip(cell.args_spec, cell.in_shardings):
        leaves = tree_leaves(args)
        specs = tree_leaves(shs, is_leaf=SH.is_spec)
        if len(leaves) == len(specs):
            total += sum(leaf_bytes(l, s) for l, s in zip(leaves, specs))
        else:
            total += sum(l.nbytes // chips for l in leaves)
    return total


def load_results(path: Path = RESULTS) -> dict:
    if path.exists():
        return json.loads(path.read_text())
    return {}


def save_result(key: str, entry: dict, path: Path = RESULTS) -> None:
    res = load_results(path)
    res[key] = entry
    path.write_text(json.dumps(res, indent=1, default=str))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both", "one"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", type=Path, default=RESULTS,
                    help="results file (default: dryrun_results_torch.json "
                         "at the repository root)")
    args = ap.parse_args()

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    done = load_results(args.out)
    failures = []
    for mesh_name in meshes:
        for arch_id in archs_on(mesh_name, archs):
            spec = get_arch(arch_id)
            shapes = [args.shape] if args.shape else list(spec.shapes)
            for shape_name in shapes:
                key = f"{arch_id}|{shape_name}|{mesh_name}"
                if key in done and done[key].get("ok") and not args.force:
                    print(f"[skip] {key}")
                    continue
                print(f"[run ] {key} ...", flush=True)
                try:
                    entry = run_cell(arch_id, shape_name, mesh_name)
                    r = entry["roofline"]
                    c = entry["collectives"]
                    print(f"[ ok ] {key}: trace={entry['t_trace_s']}s "
                          f"args/chip={entry['memory']['args_logical_bytes_per_chip']} "
                          f"peak/chip={entry['memory']['peak_bytes_per_chip']} "
                          f"collectives={c['counts']} "
                          f"link={c['link_bytes']:.0f}B "
                          f"bottleneck={r['bottleneck']} "
                          f"frac={r['roofline_fraction']:.3f}", flush=True)
                except Exception as e:
                    entry = {"arch": arch_id, "shape": shape_name,
                             "mesh": mesh_name, "ok": False,
                             "error": f"{type(e).__name__}: {e}",
                             "traceback": traceback.format_exc()[-3000:]}
                    failures.append(key)
                    print(f"[FAIL] {key}: {type(e).__name__}: {e}", flush=True)
                save_result(key, entry, args.out)
    if failures:
        print(f"\n{len(failures)} failures: {failures}")
        raise SystemExit(1)
    print("\nall cells traced")


if __name__ == "__main__":
    main()
