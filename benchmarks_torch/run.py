"""Benchmark aggregator for the PyTorch port: the reference's five device
benchmarks, one module each. Prints ``name,us_per_call,derived`` CSV and
writes ``benchmarks_torch/results.json``.

    python -m benchmarks_torch.run [--quick] [--telemetry]
        [--device cpu] [filter]

Port of ``benchmarks/run.py``. ``--device`` is ``cuda`` unless the caller
asks for ``cpu``; without a card ``cuda`` is an error, never a fallback.
``--quick`` runs every module at a tiny smoke config (the tier-1 suite
drives it, ``tests/test_torch_benchmarks_quick.py``); quick numbers are
NOT measurements, and only full unfiltered runs write results.json. The
other eleven reference benchmarks and ``roofline_report.py`` are not
ported yet (``ROADMAP.md``).
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import sys
import time
import traceback
from pathlib import Path

MODULES = [
    "benchmarks_torch.bench_feed",
    "benchmarks_torch.bench_serve",
    "benchmarks_torch.bench_kernels",
    "benchmarks_torch.bench_device_mat",
    "benchmarks_torch.fig4_ne_scaling",
]


def run_module(modname: str, quick: bool = False, telemetry=None,
               device: str = "cuda"):
    """Import + execute one benchmark module, honoring the ``quick``,
    ``telemetry`` and ``device`` knobs its ``run`` accepts."""
    mod = importlib.import_module(modname)
    params = inspect.signature(mod.run).parameters
    kw = {}
    if quick and "quick" in params:
        kw["quick"] = True
    if telemetry is not None and "telemetry" in params:
        kw["telemetry"] = telemetry
    if "device" in params:
        kw["device"] = device
    return mod.run(**kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("only", nargs="?", default=None,
                    help="run the modules whose name holds this substring")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--telemetry", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    device = str(dev)
    import torch

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device: {device} ({kind})", flush=True)
    telemetry = None
    if args.telemetry:
        from repro_torch.obs import Telemetry

        telemetry = Telemetry()
    all_results = []
    failures = []
    print("name,us_per_call,derived")
    for modname in MODULES:
        if args.only and args.only not in modname:
            continue
        t0 = time.time()
        try:
            results = run_module(modname, quick=args.quick,
                                 telemetry=telemetry, device=device)
        except Exception as e:
            failures.append(modname)
            print(f"{modname},ERROR,{type(e).__name__}: {e}", flush=True)
            traceback.print_exc(file=sys.stderr)
            continue
        for r in results:
            print(r.csv(), flush=True)
            all_results.append({"name": r.name, "us_per_call": r.us_per_call,
                                "derived": r.derived})
        print(f"# {modname} done in {time.time() - t0:.1f}s", flush=True)

    if telemetry is not None:
        # export the run's metrics/spans/events for
        # `python -m repro_torch.obs.report`
        run_dir = Path(__file__).parent / "telemetry"
        run_dir.mkdir(exist_ok=True)
        telemetry.write_run_dir(run_dir)
        print(f"# telemetry run dir: {run_dir}", flush=True)

    # persist only complete full-mode sweeps: quick numbers are smoke-test
    # noise, and a filtered run would clobber every other module's results
    if not args.quick and not args.only:
        out = Path(__file__).parent / "results.json"
        out.write_text(json.dumps({"device": device, "kind": kind,
                                   "results": all_results},
                                  indent=1, default=str))
    if failures:
        raise SystemExit(f"benchmark failures: {failures}")


if __name__ == "__main__":
    main()
