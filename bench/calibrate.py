"""The readings the limits of ``correct`` are set from; not run by the
benchmark's own runs.

    python3 bench/calibrate.py --workload <name> --seeds 1 2 3 ... [--control 3]

For each seed it runs the cell's set-up and a short window as a benchmark
run does, then holds against the reference at the configuration's precision:

* ``program``: the program's own readings (the lower readings);
* ``control``: the reference computed with float8 e4m3 operands, put in the
  program's place (first ``--control`` seeds);
* ``half_batch``: the reference with each microbatch's loss taken over its
  first half of rows, put in the program's place (a planted fault);
* ``token``: the program's first batch with one history token altered
  where the feed produced it (a planted fault; ``batch_mismatch`` only).

A step that returns its state unchanged reads 1 on ``grad_gap`` and
``change_gap`` by their definition and needs no run. Prints one JSON line a
seed, with the leaf that reads worst on each of those two numbers.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None, device: str = "cuda") -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=0.5)
    args = p.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import numpy as np
    import torch

    from bench.harness import check as C
    from bench.harness import driver
    from bench.harness.manifest import find_cell
    from bench.reference.compare import gaps, worst
    from bench.reference.precision import CONTROL, STATED

    cell = find_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = []
    for i, seed in enumerate(args.seeds):
        out = {"seed": seed}

        def judge(ref, cfg, traffic, seed, dev, first, compared, prog, opt):
            bad, ref_first = C.rebuild(traffic, seed, first, compared)

            def readings(P, half=False):
                r = C.reference_readings(ref, cfg, traffic, seed, dev,
                                         ref_first, opt, P, half=half)
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                return r

            names = ["/".join(path)
                     for path in sorted(p for p, _, _ in ref.layout(cfg))]

            def held(got):
                w = worst(got, want)
                return {**gaps(got, want),
                        "worst": {k: names[i] for k, (_, i) in w.items()}}

            want = readings(STATED)
            out["program"] = {"batch_mismatch": bad, **held(prog)}
            if i < args.control:
                out["control"] = held(readings(CONTROL))
            out["half_batch"] = held(readings(STATED, half=True))
            broken = {k: v.copy() for k, v in first[0].items()}
            lane = f"uih_{traffic['uih_traits'][0]}"
            row = int(np.argmax(broken["uih_mask"].sum(1)))
            broken[lane][row, -1] += 1
            out["token"] = {"batch_mismatch": C.rebuild(
                traffic, seed, [broken], [broken])[0]}
            return out["program"]

        t0 = time.perf_counter()
        driver.run(cell, seed, args.seconds, False, device,
                   time.perf_counter(), judge=judge)
        out["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
        lines.append(out)
    return lines


if __name__ == "__main__":
    main()
