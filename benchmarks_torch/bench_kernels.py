"""Kernel + codec micro-benchmarks on the PyTorch port.

Port of ``benchmarks/bench_kernels.py``: the same results and ``derived``
keys. The columnar codec is the host-side DPP hot path (the port's copy of
``storage.columnar``); the three kernels run through the port's ``ops``
entry points on ``device``: the CUDA kernels on a card (``delta_decode``,
``jagged_to_padded``, ``embedding_bag``, each counted in its wrapper's
``launches``), their plain versions on the CPU, whose wall times are not
device times. ``exact_match`` holds ``delta_decode`` against its plain
version, as the reference holds its Pallas kernel against the jnp oracle;
``jagged_to_padded`` must equal its plain version too, and
``embedding_bag`` match its plain version within float32 rtol 1e-5, atol
1e-6 (checked, not reported: either raises)."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmarks_torch.common import BenchResult, timeit
from repro_torch.core import events as ev
from repro_torch.kernels.delta_decode import ops as dd_ops
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.jagged import ops as jg_ops
from repro_torch.storage import columnar


def run(quick: bool = False, device: str = "cuda") -> List[BenchResult]:
    out: List[BenchResult] = []
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    schema = ev.default_schema()

    # columnar codec encode/decode rate (host-side DPP hot path)
    n = 2_000 if quick else 50_000
    ts = np.sort(rng.integers(0, 1 << 40, size=n)).astype(np.int64)
    batch = {
        "timestamp": ts,
        "item_id": rng.integers(0, 1 << 22, size=n).astype(np.int64),
        "action_type": rng.integers(0, 8, size=n).astype(np.int32),
        "like": (rng.random(n) < 0.05).astype(np.int8),
    }
    blob = columnar.encode_stripe(batch, schema)
    t_enc = timeit(lambda: columnar.encode_stripe(batch, schema))
    t_dec = timeit(lambda: columnar.decode_stripe(blob, schema))
    t_sel = timeit(lambda: columnar.decode_stripe(blob, schema,
                                                  ("timestamp", "item_id")))
    raw = sum(v.nbytes for v in batch.values())
    out.append(BenchResult("codec/encode", t_enc,
                           {"MB_per_s": round(raw / t_enc, 1),
                            "compression_ratio": round(raw / len(blob), 2)}))
    out.append(BenchResult("codec/decode_full", t_dec,
                           {"MB_per_s": round(raw / t_dec, 1)}))
    out.append(BenchResult("codec/decode_projected", t_sel,
                           {"speedup_vs_full": round(t_dec / t_sel, 2)}))

    # delta-decode kernel vs its plain version
    deltas = rng.integers(0, 1 << 16, size=(4, 64) if quick else (8, 512)
                          ).astype(np.int32)
    bases = rng.integers(0, 1 << 20, size=deltas.shape[0]).astype(np.int32)
    dj = torch.as_tensor(deltas, device=dev)
    bj = torch.as_tensor(bases, device=dev)
    got = dd_ops.delta_decode(dj, bj)
    want = dd_ops.delta_decode_ref(dj, bj)
    t_k = timeit(lambda: dd_ops.delta_decode(dj, bj), device=dev)
    out.append(BenchResult("kernel/delta_decode", t_k,
                           {"exact_match": bool(torch.equal(got, want)),
                            "elements": deltas.size}))

    # jagged->padded kernel
    rows, ml = (8, 16) if quick else (64, 64)
    lens = rng.integers(0, int(1.5 * ml), size=rows)
    offsets = np.zeros(rows + 1, np.int32); np.cumsum(lens, out=offsets[1:])
    values = rng.standard_normal((int(offsets[-1]), 128)).astype(np.float32)
    vj = torch.as_tensor(values, device=dev)
    oj = torch.as_tensor(offsets, device=dev)
    if not torch.equal(jg_ops.jagged_to_padded(vj, oj, ml),
                       jg_ops.jagged_to_padded_ref(vj, oj, ml)):
        raise AssertionError("jagged_to_padded differs from its plain version")
    t_j = timeit(lambda: jg_ops.jagged_to_padded(vj, oj, ml), device=dev)
    out.append(BenchResult("kernel/jagged_to_padded", t_j,
                           {"rows": rows, "max_len": ml, "d": 128}))

    # embedding bag kernel
    bags, bag_len = (4, 8) if quick else (32, 20)
    table = torch.as_tensor(rng.standard_normal((4096, 128)),
                            dtype=torch.float32, device=dev)
    ids = torch.as_tensor(rng.integers(0, 4096, (bags, bag_len)),
                          dtype=torch.int32, device=dev)
    mask = torch.ones((bags, bag_len), dtype=torch.bool, device=dev)
    # float32 sums in another order than the plain version's
    if not torch.allclose(eb_ops.embedding_bag(table, ids, mask),
                          eb_ops.embedding_bag_ref(table, ids, mask),
                          rtol=1e-5, atol=1e-6):
        raise AssertionError("embedding_bag differs from its plain version "
                             "beyond rtol 1e-5, atol 1e-6")
    t_e = timeit(lambda: eb_ops.embedding_bag(table, ids, mask), device=dev)
    out.append(BenchResult("kernel/embedding_bag", t_e,
                           {"bags": bags, "bag_len": bag_len, "d": 128}))
    return out


if __name__ == "__main__":
    for r in run():
        print(r.csv())
