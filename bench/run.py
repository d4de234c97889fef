"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Needs the NVIDIA cards the cell asks for: without them it exits non-zero and
prints no result. With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics and the device's busy
time from a profiler trace of the window. Either way the run checks what its
timed path produced against the plain reference, prints each number compared
beside its limit as its last lines on standard error, and ends standard
output with one JSON line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level names


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def metric_values(cell, readings, trace: bool) -> dict:
    from bench.harness.manifest import reader

    wanted = cell.per_layer if trace else cell.end_to_end
    out = {}
    for m in wanted:
        value = reader(m["name"]).read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi printed nothing")


def result(cell, out: dict, trace: bool, device: str) -> dict:
    import torch

    r = out["readings"]
    limits = cell.limits
    checks = out["checks"]
    correct = all(checks[k] <= limits[k] for k in limits)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": r.peak_bytes}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": metric_values(cell, r, trace), "device": dev}
    if trace and r.trace is not None:
        dev["busy_s"] = r.trace["busy_s"]
        dev["window_s"] = r.trace["window_s"]
        line["breakdown"] = {"device_ops": r.trace["device_ops"],
                             "idle_gaps": r.trace["idle_gaps"]}
    line["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                      for k in limits}
    return line


def main(argv=None, device: str = "cuda", faults=None) -> dict:
    """One run; returns the result line (printed as well). ``device`` and
    ``faults`` are for the tests, which drive a run on the CPU."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    os.environ.setdefault("USE_FLAX", "0")
    from bench.harness.manifest import find_cell

    cell = find_cell(args.workload)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        raise SystemExit(f"{args.workload} needs {cell.chips} CUDA card(s); "
                         f"found {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bench.harness import driver

    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     T_START, faults=faults)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded that the port must not use: "
                         f"{', '.join(found)}")
    line = result(cell, out, bool(args.trace), device)
    if device == "cuda":
        driver.say(f"card: {card_line()}")
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
