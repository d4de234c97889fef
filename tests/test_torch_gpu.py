"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: each test skips without a CUDA card (the kernels have no CPU
mode). This file imports neither jax nor the reference package, so it runs
on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.core.versioning import TrainingExample
from repro_torch.dpp import device_mat
from repro_torch.dpp.client import RebatchingClient
from repro_torch.dpp.featurize import FeatureSpec, featurize_jagged
from repro_torch.kernels.delta_decode import ops as dd
from repro_torch.kernels.embedding_bag import ops as eb
from repro_torch.kernels import runtime
from repro_torch.kernels.fused import ops
from repro_torch.kernels.jagged import ops as jg

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    return torch.device("cuda")


def _packed(rng, lens, ts0):
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    n = int(offs[-1])
    vals = {"item_id": rng.integers(0, 10**7, n).astype(np.int64),
            "score": rng.standard_normal(n).astype(np.float32)}
    ts = np.concatenate([ts0 + np.sort(rng.integers(0, 10**9, int(k)))
                         for k in lens]).astype(np.int64)
    vals["timestamp"], bases = ops.ts_delta_encode(ts, offs)
    arena, _ = ops.pack_arena(vals)
    return arena, offs.astype(np.int32), bases, 2


@pytest.mark.parametrize("seq_len,lens", [
    (2048, [0, 2048, 6000, 17, 1500, 3000, 1, 2047]),   # main-path length
    (16, [0, 0, 0]),                                    # all-empty rows
    (64, [65, 1, 200, 0, 64]),                          # over-length rows
])
def test_fused_densify_kernel_equals_plain_version(cuda, seq_len, lens):
    rng = np.random.default_rng(seq_len + len(lens))
    arena, offs, bases, ts_col = _packed(rng, lens, ts0=3_000_000_000)
    args = (torch.from_numpy(arena).to(cuda), torch.from_numpy(offs).to(cuda),
            seq_len, torch.from_numpy(bases).to(cuda), ts_col)
    before = ops.fused_densify.launches
    got = ops.fused_densify(*args)
    want = ops.fused_densify_ref(*args)
    torch.cuda.synchronize()
    assert ops.fused_densify.launches == before + (1 if sum(lens) else 0)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype
        assert torch.equal(g, w)


def _lanes_arena(rng, lens, t, ts_at=None, ts0=3_000_000_000,
                 float_lane=False, first=0):
    """A packed (arena, offsets, bases, ts_col) over rows of ``lens``: ``t``
    int32 lanes over the full int32 range, the last a float32 lane of
    -0.0/inf/NaN/denormals when ``float_lane``, and at index ``ts_at``
    delta-encoded timestamps from ``ts0`` on. ``first`` junk rows come
    before the rows (offsets start there; the kernel never reads them)."""
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    n = int(offs[-1])
    vals = {}
    for i in range(t):
        if i == ts_at:
            vals["timestamp"] = np.concatenate(
                [ts0 + np.sort(rng.integers(0, 10**9, int(k))) for k in lens]
            ).astype(np.int64)
        elif float_lane and i == t - 1:
            special = np.array([-0.0, np.inf, -np.inf, np.nan, 1e-42,
                                -1e-42, 2.5], np.float32)
            vals[f"f{i}"] = np.resize(special, n)
        else:
            vals[f"lane{i}"] = rng.integers(-2**31, 2**31, n).astype(np.int32)
    bases, ts_col = None, -1
    if ts_at is not None:
        vals["timestamp"], bases = ops.ts_delta_encode(vals["timestamp"],
                                                       offs)
        ts_col = ts_at
    arena, _ = ops.pack_arena(vals)
    junk = rng.integers(-2**31, 2**31, (first, t)).astype(np.int32)
    return (np.concatenate([junk, arena]), (offs + first).astype(np.int32),
            bases, ts_col)


def _on_card(cuda, case, seq_len, ts=True):
    """``fused_densify``'s arguments on the card; ``ts=False`` reads the
    timestamp column as a plain lane."""
    arena, offs, bases, ts_col = case
    on = ts and ts_col >= 0
    return (torch.from_numpy(arena).to(cuda), torch.from_numpy(offs).to(cuda),
            seq_len, torch.from_numpy(bases).to(cuda) if on else None,
            ts_col if on else -1)


def _densify_exact(args):
    """The kernel twice and the plain version on ``args``: two launches, and
    all three results identical to the bit (the kernel has no atomics)."""
    before = ops.fused_densify.launches
    got = ops.fused_densify(*args)
    again = ops.fused_densify(*args)
    want = ops.fused_densify_ref(*args)
    torch.cuda.synchronize()
    assert ops.fused_densify.launches == before + 2
    for g, a, w in zip(got, again, want):
        if w is None:
            assert g is None and a is None
            continue
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w) and torch.equal(a, g)
    return got


@pytest.mark.parametrize("b,seq_len,cluster,positions", [
    (32, 2048, 8, 1),      # the main path's shape
    (32, 1024, 4, 1),
    (32, 512, 2, 1),
    (1024, 2048, 1, 8),    # bound by bytes: B fills the card alone
    (32, 100, 1, 1),       # late_materialize's shape
    (1, 20000, 8, 8),      # chunks longer than 8 x 256: tiles, ranks
    (200, 5000, 1, 8),     # ... tiles in one block
])
def test_fused_densify_kernel_cluster_plan(cuda, b, seq_len, cluster,
                                           positions):
    """Each cluster size S the plan picks, timestamps on and off, equals
    the plain version exactly and run to run; rows run from empty past
    over-length, timestamps above 2^31."""
    rng = np.random.default_rng(b + seq_len)
    lens = rng.integers(0, 2 * seq_len, b)
    if b >= 3:
        lens[:3] = (0, seq_len, 3 * seq_len)
    else:
        lens[0] = seq_len - 777             # first valid mid-rank
    case = _lanes_arena(rng, lens, 4, ts_at=3)
    for ts in (True, False):
        args = _on_card(cuda, case, seq_len, ts)
        dense, _ = _densify_exact(args)
        plan = ops.launch_plan(args[0], b, seq_len, dense)
        assert (plan["cluster"], plan["positions"], plan["vec"]) == (
            cluster, positions, True), plan


def test_fused_densify_kernel_rank_boundaries(cuda):
    """At B=32, L=2048 (S=8, ranks of 256 positions): rows whose first valid
    position falls exactly on each rank boundary, rows valid only in the
    last rank, empty rows. L=2049 is not a multiple of the chunk (257), and
    L=100 and L=20 have fewer positions than a block's threads."""
    rng = np.random.default_rng(5)
    on_rank = [2048 - 256 * r for r in range(8)]
    last_rank = [1, 2, 255, 256, 0, 0]
    lens = on_rank + last_rank + list(rng.integers(0, 4096, 32 - 14))
    for seq_len, want in ((2048, (8, 256, 256)), (2049, (8, 257, 160)),
                          (100, (1, 100, 128)), (20, (1, 20, 32))):
        ls = np.minimum(lens, seq_len + 1) if seq_len < 256 else lens
        case = _lanes_arena(rng, ls, 4, ts_at=3)
        _densify_exact(_on_card(cuda, case, seq_len, ts=False))
        args = _on_card(cuda, case, seq_len)
        dense, stamps = _densify_exact(args)
        plan = ops.launch_plan(args[0], 32, seq_len, dense)
        assert (plan["cluster"], plan["chunk"], plan["threads"]) == want
        assert int(stamps.max()) > 2**31
        stamps = stamps.cpu().numpy()
        first = seq_len - np.minimum(np.asarray(ls), seq_len)
        for b in np.flatnonzero(first < seq_len):   # valid from `first` on
            assert stamps[b, first[b]] != 0 and not stamps[b, :first[b]].any()


def test_fused_densify_kernel_all_empty_rows(cuda):
    """Empty rows over a non-empty arena (offsets start 7 rows in): one
    launch, all zeros, nothing read."""
    case = _lanes_arena(np.random.default_rng(6), [0] * 6, 4, ts_at=2,
                        first=7)
    for seq_len in (2048, 64):
        for ts in (True, False):
            dense, stamps = _densify_exact(_on_card(cuda, case, seq_len, ts))
            assert not dense.any() and (stamps is None or not stamps.any())


@pytest.mark.parametrize("t,ts_at,float_lane", [
    (1, 0, False),      # a timestamp trait alone
    (1, None, False),   # a drift trait with its own offsets
    (3, 1, False),
    (5, 0, True),       # a float32 lane: -0.0, inf, NaN, denormals
    (8, 5, False),      # two 16-byte words a position
])
def test_fused_densify_kernel_lane_layouts(cuda, t, ts_at, float_lane):
    """T not a multiple of 4 moves lane by lane (the scalar path), T=8 as
    two 16-byte words; both exact, at S=8 and S=1."""
    rng = np.random.default_rng(t * 10 + (ts_at or 0))
    for b, seq_len in ((32, 2048), (8, 300)):
        lens = rng.integers(0, 2 * seq_len, b)
        args = _on_card(cuda, _lanes_arena(rng, lens, t, ts_at,
                                           float_lane=float_lane), seq_len)
        dense, _ = _densify_exact(args)
        plan = ops.launch_plan(args[0], b, seq_len, dense)
        assert plan["vec"] == (t % 4 == 0)


@pytest.mark.parametrize("t", [1, 4])
def test_fused_densify_kernel_misaligned_arena(cuda, t):
    """The arena as a row slice starting one row in (T=1: 4 bytes past an
    aligned pointer), and for T=4 a flat slice one int32 in, whose rows are
    off 16-byte alignment: the scalar path, exact."""
    rng = np.random.default_rng(40 + t)
    lens = rng.integers(0, 4096, 32)
    arena, offs, bases, ts_col = _lanes_arena(rng, lens, t, ts_at=t - 1)
    n = len(arena)
    flat = torch.zeros(n * t + 1, dtype=torch.int32, device=cuda)
    shifted = flat[1:].view(n, t)
    shifted.copy_(torch.from_numpy(arena).to(cuda))
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    args = (shifted, torch.from_numpy(offs).to(cuda), 2048,
            torch.from_numpy(bases).to(cuda), ts_col)
    dense, _ = _densify_exact(args)
    assert not ops.launch_plan(shifted, 32, 2048, dense)["vec"]


@pytest.mark.parametrize("ts", [True, False])
def test_fused_densify_kernel_one_launch_a_call(cuda, ts):
    """The main path's shape, timestamps on and off: one device kernel a
    call and no other (the outputs' allocation launches nothing)."""
    rng = np.random.default_rng(8)
    case = _lanes_arena(rng, rng.integers(0, 4096, 32), 4, ts_at=3)
    args = _on_card(cuda, case, 2048, ts)
    _one_kernel_a_call(lambda: ops.fused_densify(*args),
                       "fused_densify_kernel")


def _jagged_payloads(rng, puts=4):
    """Compact payloads of 8 rows from ``puts`` base batches, one of them
    with a drifted trait on its own offsets."""
    spec = FeatureSpec(seq_len=7, uih_traits=("item_id", "flag", "timestamp"),
                       candidate_fields=("item_id",), label_fields=("click",))
    client = RebatchingClient(8, buffer_batches=64, shuffle_seed=0,
                              emit_jagged=True)
    for k in range(puts):
        exs, uihs = [], []
        for i in range(int(rng.integers(1, 11))):
            n = int(rng.integers(0, 21))
            u = {"item_id": rng.integers(0, 100, n).astype(np.int64),
                 "flag": rng.integers(0, 2, n).astype(np.int8),
                 "timestamp": 3_000_000_000 + np.sort(
                     rng.integers(0, 10_000, n)).astype(np.int64)}
            if k == 1 and i == 1:
                u.pop("flag")                  # schema drift: own offsets
            uihs.append(u)
            exs.append(TrainingExample(
                request_id=i, user_id=i, request_ts=0, label_ts=0,
                candidate={"item_id": i}, labels={"click": 0.0}))
        client.put_jagged(featurize_jagged(exs, uihs, spec))
    client.close()
    return list(client)


def test_materializer_on_card_equals_densify_host(cuda):
    mat = device_mat.DeviceMaterializer(device=cuda)
    payloads = _jagged_payloads(np.random.default_rng(24))
    assert payloads
    for p in payloads:
        got = mat(p)
        torch.cuda.synchronize()
        want = device_mat.densify_host(p)
        assert list(got) == list(want)
        for k, w in want.items():
            g = got[k].cpu().numpy()
            assert got[k].is_cuda and g.dtype == w.dtype, k
            assert g.tobytes() == w.tobytes(), k


def test_telemetry_times_the_step_and_the_handover_on_card(cuda):
    """With telemetry on, the trainer's phases carry their device ms from
    CUDA events on its stream, and the transfer thread's ``h2d.launch``
    phases each copy's and each densify's on its side stream, all resolved
    by the time the timeline is read."""
    from repro_torch.dpp.prefetch import DevicePrefetcher
    from repro_torch.obs import Telemetry
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    payloads = _jagged_payloads(np.random.default_rng(5), puts=12)
    tel = Telemetry()
    feed = DevicePrefetcher(payloads, depth=2, device=cuda,
                            materialize=device_mat.DeviceMaterializer(
                                device=cuda))
    feed.telemetry = tel
    params = {"w": torch.full((2,), 0.5, device=cuda, requires_grad=True)}

    def loss(p, b):
        x = torch.stack([b["uih_item_id"].float().mean(1),
                         b["uih_flag"].float().mean(1)], 1) / 100.0
        return ((x @ p["w"] - b["label_click"].float()) ** 2).mean()

    trainer = Trainer(loss, params, TrainerConfig(telemetry=tel))
    trainer.fit(feed)
    assert len(trainer.history) == len(payloads)
    rows = tel.spans.timeline()
    assert tel.spans.phases_dropped == 0
    for name, keys in (("train.grads", {"grads"}),
                       ("train.optimizer", {"optimizer"}),
                       ("train.readback", {"readback"})):
        got = [r for r in rows if r["name"] == name]
        assert len(got) == len(payloads), name
        for r in got:
            assert set(r["device_ms"]) == keys, r
            assert all(v >= 0 for v in r["device_ms"].values()), r
    # a batch (one transfer cycle, from its h2d.pull): one copy an array
    # staged and one densify a kernel group, each on an h2d.launch of its own
    cycles = []
    for r in rows:
        if r["thread"] == "dpp-prefetch":
            if r["name"] == "h2d.pull":
                cycles.append([])
            cycles[-1].append(r)
    assert len(cycles) == len(payloads)
    for cycle in cycles:
        marks = [r["device_ms"] for r in cycle
                 if r["name"] == "h2d.launch" and "device_ms" in r]
        assert all(len(d) == 1 and min(d.values()) >= 0 for d in marks), marks
        staged = sum(r["name"] == "h2d.stage" for r in cycle)
        assert sum("copy" in d for d in marks) == staged, cycle
        assert sum("densify" in d for d in marks) in (1, 2), cycle
    assert all("device_ms" not in r for r in rows
               if r["name"] in ("train.feed_wait", "h2d.pull", "h2d.stage",
                                "h2d.event_wait", "h2d.offer"))


EB_V = 50_000


def _bag(rng, b, l, d, dtype, density=0.7, float_mask=False):
    """A (V, d) table and (b, l) int64 ids with a right-aligned mask; the
    padded lanes carry poisoned ids (past the table and negative).

    float32 tables have the models' init scale (``init_table``'s 0.01): the
    kernel and the plain version sum in different orders, and at L=2048 the
    difference then stays within atol 1e-6. bf16 tables are at unit scale,
    so their 1e-2 tolerance is not loose."""
    scale = 0.01 if dtype == torch.float32 else 1.0
    table = torch.from_numpy(
        scale * rng.standard_normal((EB_V, d)).astype(np.float32)).to(dtype)
    ids = rng.integers(0, EB_V, (b, l)).astype(np.int64)
    lens = (rng.random(b) * density * (l + 1)).astype(np.int64)
    mask = np.arange(l)[None, :] >= (l - lens)[:, None]
    if b:
        mask[0] = False                          # a fully masked row
        lens[-1] = l
        mask[-1] = True
    ids[~mask] = EB_V + 1000
    ids[:, :1][~mask[:, :1]] = -7
    m = torch.from_numpy(mask)
    if float_mask:
        m = m * torch.from_numpy(rng.random((b, l)).astype(np.float32))
    return table, torch.from_numpy(ids), m


@pytest.mark.parametrize("b,l,d,dtype,float_mask", [
    (32, 100, 256, torch.float32, False),     # late_materialize's shape
    (32, 2048, 256, torch.float32, False),    # the training history length
    (5, 37, 100, torch.float32, True),        # D=100, float weight mask
    (9, 100, 256, torch.bfloat16, False),     # bf16 table
    (4, 13, 100, torch.bfloat16, True),       # bf16, D=100: scalar loads
    (0, 8, 256, torch.float32, False),        # empty batch
    (3, 0, 256, torch.float32, False),        # empty bags
])
def test_embedding_bag_kernel_equals_plain_version(cuda, b, l, d, dtype,
                                                   float_mask):
    rng = np.random.default_rng(b * 1000 + l + d)
    table, ids, mask = (t.to(cuda) for t in _bag(rng, b, l, d, dtype,
                                                 float_mask=float_mask))
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-2))
    for combiner in ("sum", "mean"):
        before = eb.embedding_bag.launches
        got = eb.embedding_bag(table, ids, mask, combiner)
        want = eb.embedding_bag_ref(table, ids, mask, combiner)
        torch.cuda.synchronize()
        assert eb.embedding_bag.launches == before + (1 if b and l else 0)
        assert got.device.type == cuda.type and got.dtype == dtype
        assert got.shape == (b, d)
        torch.testing.assert_close(got.float(), want.float(), **tol)
    if b:
        assert not eb.embedding_bag(table, ids, mask)[0].any()


def test_late_materialize_on_card_equals_to_padded(cuda):
    rng = np.random.default_rng(7)
    spec = FeatureSpec(seq_len=100, uih_traits=("item_id", "timestamp"))
    exs, uihs = [], []
    for i in range(32):
        n = int(rng.integers(0, 300))
        uihs.append({"item_id": rng.integers(0, EB_V, n).astype(np.int64),
                     "timestamp": 3_000_000_000 + np.sort(
                         rng.integers(0, 10**9, n)).astype(np.int64)})
        exs.append(TrainingExample(request_id=i, user_id=i, request_ts=0,
                                   label_ts=0, candidate={}, labels={}))
    jf = featurize_jagged(exs, uihs, spec)
    table = torch.randn((EB_V, 256), device=cuda)
    launches = (ops.fused_densify.launches, eb.embedding_bag.launches)
    out = ops.late_materialize(jf.values, jf.offsets, 100,
                               ts_trait="timestamp", table=table,
                               ids_trait="item_id", combiner="mean",
                               device=cuda)
    torch.cuda.synchronize()
    assert (ops.fused_densify.launches, eb.embedding_bag.launches) == (
        launches[0] + 1, launches[1] + 1)
    want = jf.to_padded()
    for trait in ("item_id", "timestamp"):
        got = out["traits"][trait].cpu().numpy()
        w = want[f"uih_{trait}"]
        assert got.dtype == w.dtype and got.tobytes() == w.tobytes(), trait
    assert out["mask"].cpu().numpy().tobytes() == want["uih_mask"].tobytes()
    ref = eb.embedding_bag_ref(table, out["traits"]["item_id"], out["mask"],
                               "mean")
    torch.testing.assert_close(out["pooled"], ref, rtol=1e-5, atol=1e-6)


def _jagged(rng, lens, d, dtype, first=0, offsets_dtype=torch.int64):
    """(N, d) values of ``dtype`` over offsets of ``lens`` starting at
    ``first`` (rows before it are never read), as card tensors."""
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    offs += first
    x = rng.standard_normal((int(offs[-1]), d)) * 50
    if dtype == torch.bool:
        values = torch.from_numpy(x > 0)
    elif dtype == torch.int64:
        values = torch.from_numpy(2**40 + x.astype(np.int64))
    else:
        values = torch.from_numpy(x.astype(np.float32)).to(dtype)
    return values, torch.from_numpy(offs).to(offsets_dtype)


_MAIN_LENS = list(np.random.default_rng(0).integers(0, 4096, 32))


@pytest.mark.parametrize("lens,l,d,dtype,first,offsets_dtype", [
    (_MAIN_LENS, 2048, 128, torch.float32, 0, torch.int32),   # main shape
    ([3, 0, 40, 17, 1], 16, 1, torch.bfloat16, 0, torch.int32),
    ([3, 0, 40, 17, 1], 16, 130, torch.bfloat16, 0, torch.int64),
    ([3, 0, 40, 17, 1], 16, 3, torch.int8, 0, torch.int32),
    ([9, 30, 0, 5], 12, 1, torch.int64, 0, torch.int64),      # > 2^31
    ([9, 30, 0, 5], 12, 5, torch.bool, 0, torch.int32),
    ([9, 30, 0, 5], 12, 64, torch.float16, 7, torch.int32),   # offsets[0] 7
    ([0, 0, 0], 8, 4, torch.float32, 0, torch.int32),         # N == 0
    ([], 8, 4, torch.float32, 0, torch.int32),                # B == 0
])
def test_jagged_to_padded_kernel_equals_plain_version(
        cuda, lens, l, d, dtype, first, offsets_dtype):
    rng = np.random.default_rng(len(lens) + d)
    values, offs = (t.to(cuda) for t in _jagged(rng, lens, d, dtype, first,
                                                  offsets_dtype))
    before = jg.jagged_to_padded.launches
    got = jg.jagged_to_padded(values, offs, l)
    want = jg.jagged_to_padded_ref(values, offs, l)
    torch.cuda.synchronize()
    assert jg.jagged_to_padded.launches == before + (1 if sum(lens) else 0)
    assert got.is_cuda and got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.uint8),
                       want.cpu().view(torch.uint8))


def test_jagged_to_padded_kernel_malformed_offsets(cuda):
    """Negative lengths give zero rows; ends past the arena read its last
    row; a negative end reads its first."""
    values = torch.arange(36, dtype=torch.float32, device=cuda).view(12, 3)
    offs = torch.tensor([0, 5, 2, 12, 15, -3, 1], device=cuda)
    got = jg.jagged_to_padded(values, offs, 6)
    want = jg.jagged_to_padded_ref(values, offs, 6)
    assert torch.equal(got, want)
    assert not got[1].any() and torch.equal(got[3, 5], values[11])


def test_jagged_to_padded_kernel_misaligned_slice(cuda):
    """An arena that is a slice starting mid-line takes 4- or 1-byte words
    and still equals the plain version; the aligned arena takes 16."""
    rng = np.random.default_rng(2)
    lens = [7, 0, 33, 12]
    offs = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), device=cuda)
    n = int(offs[-1])
    flat = torch.from_numpy(rng.standard_normal(n * 4 + 1).astype(
        np.float32)).to(cuda)
    for values, width in ((flat[:-1].view(n, 4), 16),
                          (flat[1:].view(n, 4), 4),
                          (flat.view(torch.uint8)[1:1 + n * 4].view(n, 4), 1)):
        got = jg.jagged_to_padded(values, offs, 16)
        want = jg.jagged_to_padded_ref(values, offs, 16)
        torch.cuda.synchronize()
        assert jg.word_bytes(values, got) == width
        assert torch.equal(got, want)


def test_jagged_to_padded_refuses_what_it_would_copy(cuda):
    values = torch.zeros((10, 8), device=cuda)
    offs = torch.tensor([0, 4, 10], device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        jg.jagged_to_padded(values[:, ::2], offs, 4)
    with pytest.raises(ValueError, match="CUDA or all on the CPU"):
        jg.jagged_to_padded(values, offs.cpu(), 4)


def _decode_case(rng, b, n, dtype, base0=0):
    hi = 2**20 if dtype == torch.int32 else 2**40
    deltas = rng.integers(-hi, hi, (b, n))
    bases = base0 + rng.integers(-hi, hi, b)
    return (torch.from_numpy(deltas).to(dtype),
            torch.from_numpy(bases).to(dtype))


@pytest.mark.parametrize("b,n,dtype,base0", [
    (32, 2048, torch.int32, 0),            # the main path's window lane
    (32, 2048, torch.int64, 3_000_000_000),
    (1024, 2048, torch.int64, 0),
    (7, 1025, torch.int32, 0),             # a partial tile
    (3, 1, torch.int64, 2**40),
    (0, 16, torch.int32, 0),
    (4, 0, torch.int64, 0),
])
def test_delta_decode_kernel_equals_plain_version(cuda, b, n, dtype, base0):
    rng = np.random.default_rng(b + n)
    deltas, bases = (t.to(cuda) for t in _decode_case(rng, b, n, dtype,
                                                      base0))
    before = dd.delta_decode.launches
    got = dd.delta_decode(deltas, bases)
    want = dd.delta_decode_ref(deltas, bases)
    torch.cuda.synchronize()
    assert dd.delta_decode.launches == before + (1 if b and n else 0)
    assert got.is_cuda and got.dtype == dtype and torch.equal(got, want)


def test_delta_decode_kernel_wraps_and_carries_wide_windows(cuda):
    """int32 wraps bit for bit; int64 spans of 2^33 are exact; mixed inputs
    decode in int64."""
    d32 = torch.full((3, 3000), 2**30, dtype=torch.int32, device=cuda)
    b32 = torch.tensor([2**31 - 1, -(2**31), 5], dtype=torch.int32,
                       device=cuda)
    want = ((torch.cumsum(d32.long(), 1) + b32.long()[:, None]) % 2**32)
    want = torch.where(want >= 2**31, want - 2**32, want).int()
    assert torch.equal(dd.delta_decode(d32, b32), want)
    d64 = torch.tensor([[0, 2**33, 5], [3, -(2**34), 2**40]], device=cuda)
    b64 = torch.tensor([7, -9], device=cuda)
    assert torch.equal(dd.delta_decode(d64, b64),
                       torch.cumsum(d64, 1) + b64[:, None])
    got = dd.delta_decode(d32, b32.long())
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.cumsum(d32.long(), 1) + b32.long()[:, None])


def test_wrappers_on_the_card_never_run_the_plain_versions(cuda, monkeypatch):
    """With the plain versions broken, the card results still come right:
    the wrappers launched their kernels."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(jg, "jagged_to_padded_ref", boom)
    monkeypatch.setattr(dd, "delta_decode_ref", boom)
    values = torch.arange(1.0, 4.0, device=cuda)[:, None]
    got = jg.jagged_to_padded(values, torch.tensor([0, 1, 3], device=cuda), 2)
    assert got[:, :, 0].tolist() == [[0.0, 1.0], [2.0, 3.0]]
    got = dd.delta_decode(torch.tensor([[0, 1, 2]], dtype=torch.int32,
                                       device=cuda),
                          torch.tensor([5], dtype=torch.int32, device=cuda))
    assert got.tolist() == [[5, 6, 8]]


def _device_kernels(fn, calls=10, attempts=4):
    """name -> records of the device kernels that ``calls`` calls of ``fn``
    launch, from a ``torch.profiler`` trace with a warm-up cycle, as
    ``chip_smoke.py``'s timings take it. The trace drops records now and
    then, once in a while all of them, and now and then a record of the
    warm-up cycle lands in the counted one: a trace in which no kernel has
    records for half the calls, or one has more records than calls, is
    taken again, up to ``attempts`` traces."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = collections.Counter({
            e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count})
        if (any(2 * n >= calls for n in kernels.values())
                and all(n <= calls for n in kernels.values())):
            break
    return kernels


def _one_kernel_a_call(fn, name, calls=10):
    kernels = _device_kernels(fn, calls)
    assert kernels and all(name in k for k in kernels), dict(kernels)
    assert 0 < sum(kernels.values()) <= calls, dict(kernels)


def _mask_as(mask, kind, rng):
    """A bool mask as ``kind``: itself, or float32/bf16 weights in (0, 1]
    under it."""
    if kind == "bool":
        return mask
    w = torch.from_numpy(rng.random(tuple(mask.shape)).astype(np.float32))
    w = (w.to(mask.device) + 0.25) * mask
    return w.to(getattr(torch, kind))


F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("mask_kind", ["bool", "float32", "bfloat16"])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_embedding_bag_kernel_reads_the_callers_dtypes(cuda, ids_dtype,
                                                       mask_kind):
    """int32 or int64 ids and a bool, float32 or bf16 mask: one launch a
    call under sum and mean, equal to the plain version. int64 ids of
    +-(2^32 + k) wrap to int32 before the clamp."""
    rng = np.random.default_rng(len(mask_kind) + ids_dtype.itemsize)
    table, ids, mask = (t.to(cuda) for t in _bag(rng, 32, 100, 256,
                                                 torch.float32))
    if ids_dtype == torch.int64:
        ids[1:, 5] = 2**32 + 5                 # row 5
        ids[1:, 6] = -(2**32) - 1              # -1: row 0
        ids[1:, 7] = 2**31 + 3                 # negative: row 0
        ids[1:, 8] = 3 * 2**32 + EB_V + 9      # EB_V + 9: row EB_V - 1
    ids = ids.to(ids_dtype)
    weights = _mask_as(mask, mask_kind, rng)
    for combiner in ("sum", "mean"):
        before = eb.embedding_bag.launches
        got = eb.embedding_bag(table, ids, weights, combiner)
        want = eb.embedding_bag_ref(table, ids, weights, combiner)
        torch.cuda.synchronize()
        assert eb.embedding_bag.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == (32, 256)
        torch.testing.assert_close(got, want, **F32)
        _one_kernel_a_call(lambda: eb.embedding_bag(table, ids, weights,
                                                    combiner),
                           "embedding_bag_kernel")
    if ids_dtype == torch.int64:               # the wrap, without the plain
        one = torch.ones((1, 1), dtype=torch.bool, device=cuda)
        for wide, row in ((2**32 + 5, 5), (-(2**32) - 1, 0),
                          (2**31 + 3, 0), (3 * 2**32 + EB_V + 9, EB_V - 1)):
            bag = eb.embedding_bag(table, torch.full((1, 1), wide,
                                                     device=cuda), one)
            assert torch.equal(bag[0], table[row]), (wide, row)


@pytest.mark.parametrize("mask_kind", ["bool", "float32", "bfloat16"])
def test_embedding_bag_kernel_bf16_table_every_mask(cuda, mask_kind):
    """A bf16 table weighs each position by the mask rounded to bf16. The
    table's entries are +-2^k, so every weighted row is exact in bf16 and
    the plain version (which rounds each product) and the kernel (which
    sums exact products in float32) differ only in summation order. A bag
    of 100 positions of 0.3 over a row of ones sums bf16(0.3) = 0.30078125
    a position: 30.078125, 30.125 in bf16 (30.0 unrounded)."""
    rng = np.random.default_rng(40 + len(mask_kind))
    _, ids, mask = (t.to(cuda) for t in _bag(rng, 16, 300, 256,
                                             torch.bfloat16))
    table = torch.from_numpy(rng.choice([-1.0, 1.0], (EB_V, 256)) * 2.0 **
                             rng.integers(-3, 4, (EB_V, 256))).to(
        torch.bfloat16).to(cuda)
    weights = _mask_as(mask, mask_kind, rng)
    for combiner in ("sum", "mean"):
        got = eb.embedding_bag(table, ids, weights, combiner)
        want = eb.embedding_bag_ref(table, ids, weights, combiner)
        torch.testing.assert_close(got.float(), want.float(), **BF16)
    if mask_kind != "bool":
        ones = torch.ones((4, 256), dtype=torch.bfloat16, device=cuda)
        w = torch.full((1, 100), 0.3, device=cuda).to(getattr(torch,
                                                              mask_kind))
        got = eb.embedding_bag(ones, torch.zeros((1, 100), dtype=torch.int64,
                                                 device=cuda), w)
        assert (got == 30.125).all()


def test_embedding_bag_kernel_bf16_mean_count_rounds(cuda):
    """At L=2048 a bool count above 256 rounds to bf16 before the mean
    divides: a count of 1028 is 1024 and 259 is 260, so the kernel gives
    exactly bf16(num / bf16(count)), where num / count would differ."""
    l = 2048
    table = torch.zeros((16, 256), dtype=torch.bfloat16, device=cuda)
    table[1] = 256.0
    counts, hits = [1028, 259, 0, 2048], [4, 1, 3, 8]
    ids = torch.zeros((4, l), dtype=torch.int64, device=cuda)
    mask = torch.zeros((4, l), dtype=torch.bool, device=cuda)
    for b, (c, h) in enumerate(zip(counts, hits)):
        mask[b, l - c:] = True
        ids[b, l - h:] = 1                   # num = 256 * hits under the mask
    got = eb.embedding_bag(table, ids, mask, "mean")
    want = eb.embedding_bag_ref(table, ids, mask, "mean")
    num = torch.tensor([256.0 * h if c else 0.0 for c, h in
                        zip(counts, hits)]).to(torch.bfloat16)
    den = torch.tensor([max(c, 1) for c in counts]).to(torch.bfloat16)
    exact = (num.float() / den.float()).to(torch.bfloat16)
    unrounded = (num.float() / torch.tensor(
        [max(c, 1) for c in counts], dtype=torch.float32)).to(torch.bfloat16)
    assert not torch.equal(exact, unrounded)   # the case discriminates
    assert torch.equal(got[:, 0].cpu(), exact)
    assert torch.equal(want[:, 0].cpu(), exact)
    assert torch.equal(got, want)
    assert eb.launch_plan(table, 4, l, got)["cluster"] == 8


@pytest.mark.parametrize("b,l,cluster", [
    (256, 100, 1),     # B fills the card alone
    (1, 2048, 8),
    (32, 2048, 8),     # the training history length
    (32, 100, 4),      # late_materialize's shape
])
def test_embedding_bag_kernel_cluster_split(cuda, b, l, cluster):
    rng = np.random.default_rng(b + l)
    table, ids, mask = (t.to(cuda) for t in _bag(rng, b, l, 256,
                                                 torch.float32))
    for combiner in ("sum", "mean"):
        got = eb.embedding_bag(table, ids, mask, combiner)
        want = eb.embedding_bag_ref(table, ids, mask, combiner)
        torch.testing.assert_close(got, want, **F32)
        again = eb.embedding_bag(table, ids, mask, combiner)
        assert torch.equal(got, again)           # no atomics: run to run
    assert eb.launch_plan(table, b, l, got) == {"cluster": cluster, "vec": 4,
                                                "chunks": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_scalar_path(cuda, dtype):
    """A table slice that starts 8 bytes past 16-byte alignment, and bf16
    rows of D=100 (200 bytes), take the scalar path; float32 rows of D=100
    (400 bytes) are whole 16-byte vectors. All equal the plain version."""
    rng = np.random.default_rng(9)
    tol = F32 if dtype == torch.float32 else BF16
    table, ids, mask = (t.to(cuda) for t in _bag(rng, 5, 37, 100, dtype))
    flat = torch.from_numpy(0.01 * rng.standard_normal(
        EB_V * 256 + 8).astype(np.float32)).to(dtype).to(cuda)
    shifted = flat[8 // flat.element_size():][:EB_V * 256].view(EB_V, 256)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    for tab in (table, shifted):
        for combiner in ("sum", "mean"):
            got = eb.embedding_bag(tab, ids, mask, combiner)
            want = eb.embedding_bag_ref(tab, ids, mask, combiner)
            torch.testing.assert_close(got.float(), want.float(), **tol)
        vec = 16 // dtype.itemsize
        whole = tab is table and 100 % vec == 0
        assert eb.launch_plan(tab, 5, 37, got)["vec"] == (vec if whole else 1)


def test_embedding_bag_kernel_nan_row_under_weight_zero(cuda):
    """A masked row is multiplied by zero, not skipped: a NaN row turns the
    bag NaN, as in the plain version and the TPU kernel."""
    table = torch.ones((8, 256), device=cuda)
    table[3] = float("nan")
    ids = torch.tensor([[1, 3, 2], [1, 2, 2]], device=cuda)
    mask = torch.tensor([[True, False, True], [True, True, False]],
                        device=cuda)
    for combiner in ("sum", "mean"):
        got = eb.embedding_bag(table, ids, mask, combiner)
        want = eb.embedding_bag_ref(table, ids, mask, combiner)
        assert got[0].isnan().all() and want[0].isnan().all()
        assert torch.equal(got[1], want[1])


def test_kernels_launch_on_the_callers_stream(cuda):
    """The raw stream handle is the caller's current stream, a side stream
    included (DevicePrefetcher launches on one), and a launch there is
    right once that stream is synchronized."""
    assert runtime.raw_stream(torch.zeros(1, device=cuda)) == \
        torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(1)
    table, ids, mask = (t.to(cuda) for t in _bag(rng, 8, 64, 256,
                                                 torch.float32))
    d = torch.from_numpy(rng.integers(-99, 99, (8, 64))).to(cuda)
    densify = _on_card(cuda, _lanes_arena(rng, rng.integers(0, 4096, 32), 4,
                                          ts_at=3), 2048)
    values = torch.from_numpy(rng.standard_normal((500, 128)).astype(
        np.float32)).to(cuda)
    offs = torch.tensor([0, 7, 7, 300, 500], device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert runtime.raw_stream(table) == side.cuda_stream != \
            torch.cuda.default_stream().cuda_stream
        bag = eb.embedding_bag(table, ids, mask, "mean")
        dec = dd.delta_decode(d, d[:, 0])
        dense, stamps = ops.fused_densify(*densify)
        padded = jg.jagged_to_padded(values, offs, 256)
    side.synchronize()
    torch.testing.assert_close(bag, eb.embedding_bag_ref(table, ids, mask,
                                                         "mean"), **F32)
    assert torch.equal(dec, dd.delta_decode_ref(d, d[:, 0]))
    want = ops.fused_densify_ref(*densify)
    assert torch.equal(dense, want[0]) and torch.equal(stamps, want[1])
    assert torch.equal(padded, jg.jagged_to_padded_ref(values, offs, 256))


@pytest.mark.parametrize("d_dtype,b_dtype", [(torch.int32, torch.int64),
                                             (torch.int64, torch.int32)])
def test_delta_decode_kernel_mixed_widths_one_launch(cuda, d_dtype, b_dtype):
    """Mixed inputs decode in int64 with one launch and no cast."""
    rng = np.random.default_rng(d_dtype.itemsize)
    deltas = torch.from_numpy(rng.integers(-2**30, 2**30, (32, 2048))).to(
        d_dtype).to(cuda)
    bases = torch.from_numpy(3_000_000_000 + rng.integers(0, 2**30, 32)).to(
        b_dtype).to(cuda)
    before = dd.delta_decode.launches
    got = dd.delta_decode(deltas, bases)
    want = dd.delta_decode_ref(deltas, bases)
    assert dd.delta_decode.launches == before + 1
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert dd.vector_path(deltas, got)
    _one_kernel_a_call(lambda: dd.delta_decode(deltas, bases),
                       "delta_decode_kernel")


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["N=2047", "N=1030", "column slice"])
def test_delta_decode_kernel_scalar_path(cuda, case, dtype):
    """N not a multiple of 4, and a column slice x[:, 1:] read in place
    (its rows start mid-vector), stay exact. Rows that do not start 16-byte
    aligned take the scalar path (an even N is aligned for int64, whose
    ragged row end is scalar); the slice is not copied (one kernel a
    call)."""
    rng = np.random.default_rng(len(case) + dtype.itemsize)
    n = {"N=2047": 2047, "N=1030": 1030, "column slice": 2049}[case]
    x = torch.from_numpy(rng.integers(-2**20, 2**20, (33, n))).to(dtype).to(
        cuda)
    bases = torch.from_numpy(rng.integers(-2**30, 2**30, 33)).to(dtype).to(
        cuda)
    deltas = x[:, 1:] if case == "column slice" else x
    got = dd.delta_decode(deltas, bases)
    assert torch.equal(got, dd.delta_decode_ref(deltas, bases))
    aligned = case != "column slice" and n * dtype.itemsize % 16 == 0
    assert dd.vector_path(deltas, got) == aligned
    if case == "column slice":
        _one_kernel_a_call(lambda: dd.delta_decode(deltas, bases),
                           "delta_decode_kernel")


def _tenant_batch(name, cfg, rng, b):
    """A SMOKE tenant's model inputs from a numpy ``rng``: right-aligned
    histories, row 0 all masked."""
    label = (rng.random(b) < 0.3).astype(np.float32)
    if name == "dcn-v2":
        return {"sparse_ids": rng.integers(0, cfg.field_vocab,
                                           (b, cfg.n_sparse)),
                "dense": rng.random((b, cfg.n_dense)).astype(np.float32),
                "label": label}
    s = cfg.seq_len
    lens = rng.integers(0, s + 1, b)
    lens[0] = 0
    mask = np.arange(s)[None, :] >= (s - lens)[:, None]
    batch = {"uih_item_id": rng.integers(0, cfg.item_vocab, (b, s)),
             "uih_mask": mask,
             "cand_item_id": rng.integers(0, cfg.item_vocab, b)}
    if name == "dien":
        batch["uih_category"] = rng.integers(0, cfg.cat_vocab, (b, s))
        batch["cand_category"] = rng.integers(0, cfg.cat_vocab, b)
        batch["label"] = label
    else:
        batch["mask_pos"] = (rng.random((b, s)) < 0.3) & mask
        batch["neg_ids"] = rng.integers(0, cfg.item_vocab, 32)
    return batch


@pytest.mark.parametrize("name", ["dcn-v2", "dien", "bert4rec"])
def test_smoke_tenant_on_card_equals_cpu(cuda, name, monkeypatch):
    """A SMOKE tenant's forward and loss on the card against the CPU, float32
    with TF32 off, from the same parameters and batch (rtol 1e-4, atol 1e-5,
    as the CPU parity tests)."""
    from repro_torch.configs import bert4rec, dcn_v2, dien
    from repro_torch.models import recsys as R
    from repro_torch.tree import tree_map

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, init, forward, loss = {
        "dcn-v2": (dcn_v2.SMOKE, R.init_dcn_v2, R.dcn_v2_forward,
                   R.dcn_v2_loss),
        "dien": (dien.SMOKE, R.init_dien, R.dien_forward, R.dien_loss),
        "bert4rec": (bert4rec.SMOKE, R.init_bert4rec, R.bert4rec_forward,
                     R.bert4rec_loss)}[name]
    batch = {k: torch.from_numpy(v) for k, v in _tenant_batch(
        name, cfg, np.random.default_rng(len(name)), 8).items()}
    cpu = init(cfg, seed=0, device="cpu")
    card = tree_map(lambda t: t.detach().to(cuda), cpu)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    for fn in (forward, loss):
        want = fn(cpu, batch, cfg).detach()
        got = fn(card, on_card, cfg).detach()
        assert got.is_cuda and torch.isfinite(got).all()
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch,shape", [("dlrm-uih", "train_batch"),
                                        ("dcn-v2", "serve_p99"),
                                        ("dien", "retrieval_cand"),
                                        ("qwen3-4b", "train_4k"),
                                        ("deepseek-v2-lite-16b",
                                         "prefill_32k"),
                                        ("qwen3-moe-30b-a3b", "decode_32k"),
                                        ("meshgraphnet", "full_graph_sm")])
def test_smoke_cell_on_card_equals_cpu(cuda, arch, shape, monkeypatch):
    """One SMOKE cell of each kind (``launch.steps``; recsys train, serve
    and retrieval, LM train, prefill and decode, GNN train) run on the card
    and on the CPU from the same sampled arguments: float32 with TF32 off,
    rtol 1e-4, atol 1e-5 (the CPU parity tests' tolerance; the GNN's
    scatter adds with atomics on the card, in another order)."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sampling import sample_args
    from repro_torch.launch.steps import build_cell
    from repro_torch.train.optimizer import AdamWState, adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    mesh = make_test_mesh(1, "cpu")
    try:
        cell = build_cell(get_arch(arch), shape, mesh, use_full=False)
    finally:
        dist.destroy_process_group()
    cpu = sample_args(cell, get_arch(arch).family, seed=0, device="cpu")
    card = [tree_map(lambda t: t.detach().clone().to(cuda), a)
            for a in cpu]
    if cell.kind == "train":
        card[1] = adamw_init(card[0])
    want = cell.step_fn(*cpu)
    got = cell.step_fn(*card)
    if cell.kind == "train":
        assert isinstance(got[1], AdamWState) and int(got[1].step) == 1
        pairs = (list(zip(tree_leaves(got[0]), tree_leaves(want[0])))
                 + [(got[2][k], want[2][k]) for k in ("loss", "grad_norm")])
    else:           # a tensor, or (logits, cache)
        pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    for g, w in pairs:
        g, w = torch.as_tensor(g), torch.as_tensor(w)
        assert g.device.type == "cuda" and torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.detach().cpu().float(),
                                   w.detach().float(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_zoo_cell_on_a_thread_mesh_equals_one_rank(cuda, shape, monkeypatch):
    """SMOKE Qwen3-4B's ``shape`` cell as the rank-local program of a
    (1, 4) mesh whose ranks are threads on the card (its 2 KV heads split
    below a head; ``launch.threaded.ThreadedMesh``), each rank's output
    block against the same block of the single-device program on the card:
    float32 compute with TF32 off, rtol = atol = 1e-5 (the CPU mesh tests'
    tolerance). The vocabulary is rounded up to a multiple of 4, as the
    reference's placement requires."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.sampling import local_args
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.threaded import ThreadedMesh
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    spec = get_arch("qwen3-4b")
    cfg = dataclasses.replace(spec.smoke, vocab=176)
    with torch.no_grad():
        params = tree_map(lambda p: p.detach(), T.init(
            cfg, seed=0, device=cuda, dtype=torch.bfloat16))
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device=cuda)
    if shape == "prefill_32k":
        args = (params, {"tokens": tokens})
        with torch.no_grad():
            want = T.prefill(params, tokens, cfg)
    else:
        cache = {k: v.normal_(generator=gen) for k, v in
                 T.init_kv_cache(cfg, 2, 64, device=cuda).items()}
        step = {"token": tokens[:, 0],
                "position": torch.tensor([5, 40], device=cuda)}
        args = (params, cache, step)
        with torch.no_grad():
            want = T.decode_step(params, tree_map(torch.clone, cache),
                                 step["token"], step["position"], cfg)

    def run(rank, mesh):
        cell = build_cell(spec, shape, mesh, use_full=False, cfg_override=cfg)
        got = cell.step_fn(*local_args(cell, args, mesh))
        specs = tree_leaves(cell.out_shardings, is_leaf=SH.is_spec)
        return [(g.cpu(), SH.local_block(w, sp, mesh).cpu()) for g, w, sp
                in zip(tree_leaves(got), tree_leaves(want), specs)]

    with ThreadedMesh((1, 4), device_type="cuda", timeout=300) as tm:
        ranks = tm.run(run)
    for pairs in ranks:
        for g, w in pairs:
            assert g.shape == w.shape
            torch.testing.assert_close(g.float(), w.float(), rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# The multi-tensor AdamW kernel (kernels/adamw)
# ---------------------------------------------------------------------------

# The kernel against its plain per-leaf version on the same leaves, float32
# both: the kernel sums the norm's squares in float64 partials (the plain
# version in float32, in its own order), scales the gradient by one product
# s * min(1, clip / norm) where the plain version rounds twice, and contracts
# multiply-adds. Each moves the last place of g, m, v and the update; three
# steps compound it. rtol 2e-5 on p, m and v; atol 1e-6 for elements near 0
# (lr 1e-3 times a last-place change of an update of order 1).
AW_TOL = dict(rtol=2e-5, atol=1e-6)
AW_STEP = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8)


def _aw_case(cuda, rng, weight_decay):
    """Leaves of lengths 1, 3, 4097 and 70,001 (two chunks, a ragged end),
    a 2-D leaf, a parameter that is a column slice (not contiguous) and a
    parameter and second moment that are views at odd offsets of flat
    buffers (not 16-byte aligned), as the benchmark's weights are."""
    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(cuda)

    shapes = [(1,), (3,), (4097,), (70_001,), (96, 40), (50, 30), (50, 100)]
    params = [f32(*s) for s in shapes[:5]]
    wide = f32(50, 60)
    params.append(wide[:, ::2])
    flat = f32(1 + 5000)
    params.append(flat[1:].view(50, 100))
    ms = [f32(*s, scale=0.1) for s in shapes]
    vs = [f32(*s, scale=0.1).abs() for s in shapes]
    flat_v = f32(3 + 5000).abs()
    flat_v[3:] = vs[-1].flatten()
    vs[-1] = flat_v[3:].view(50, 100)
    assert not params[5].is_contiguous()
    assert params[6].data_ptr() % 16 and vs[6].data_ptr() % 16
    decay = [weight_decay * (len(s) >= 2) for s in shapes]
    return params, ms, vs, decay


def _aw_kwargs(step, clip, grad_scale):
    f = np.float32
    return dict(AW_STEP, bc1=float(f(1) - f(0.9) ** f(step)),
                bc2=float(f(1) - f(0.95) ** f(step)), clip=clip,
                grad_scale=grad_scale)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("clip", [0.5, 1e6, 0.0])   # active, inactive, off
@pytest.mark.parametrize("grad_scale,given", [(1.0, False), (0.5, False),
                                              (1.0, True), (0.5, True)])
def test_adamw_kernel_equals_plain_version(cuda, weight_decay, clip,
                                           grad_scale, given):
    from repro_torch.kernels.adamw import ops as aw

    rng = np.random.default_rng(7)
    params, ms, vs, decay = _aw_case(cuda, rng, weight_decay)
    plain = [[t.clone() for t in ts] for ts in (params, ms, vs)]
    before = (aw.adamw.launches, aw.adamw.leaves, aw.adamw.staged)
    for step in (1, 2, 3):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32)).to(cuda) for p in params]
        kept = [g.clone() for g in grads]
        gnorm = aw.global_norm(grads) if given else None
        kw = _aw_kwargs(step, clip, grad_scale)
        got = aw.adamw(params, grads, ms, vs, decay, **kw, gnorm=gnorm)
        want = aw.adamw_ref(*plain[:1], [g.clone() for g in grads],
                            *plain[1:], decay, **kw, gnorm=gnorm)
        torch.cuda.synchronize()
        # the norm: float64 partials against a float32 reduction
        torch.testing.assert_close(got, want, rtol=2e-6, atol=0)
        assert all(torch.equal(g, k) for g, k in zip(grads, kept))
    # the column slice was updated through a copy written back into it
    for got, want in zip(params + ms + vs, sum(plain, [])):
        torch.testing.assert_close(got, want, **AW_TOL)
    launches = 3 * (1 if given else 2)
    assert (aw.adamw.launches, aw.adamw.leaves, aw.adamw.staged) == (
        before[0] + launches, before[1] + 3 * 7, before[2] + 3)


def test_adamw_kernel_is_deterministic_and_copies_its_table_once(cuda):
    """Two runs from equal states read equal bits (the norm's partials are
    summed in one fixed order); the leaf table a state keeps is copied to
    the card once while no pointer changes, and again when the gradients
    move; without a table each call copies its own."""
    from repro_torch.kernels.adamw import ops as aw

    rng = np.random.default_rng(3)
    params, ms, vs, decay = _aw_case(cuda, rng, 0.1)
    twin = [[t.clone() for t in ts] for ts in (params, ms, vs)]
    grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32) * 50).to(cuda) for p in params]
    kw = _aw_kwargs(1, 1.0, 0.5)
    table, twin_table = aw.LeafTable(), aw.LeafTable()
    uploads = aw.adamw.uploads
    norms = [aw.adamw(params, grads, ms, vs, decay, **kw, table=table)
             for _ in range(2)]
    assert aw.adamw.uploads == uploads + 1
    twin_grads = [g.clone() for g in grads]
    twin_norms = [aw.adamw(twin[0], twin_grads, twin[1], twin[2], decay,
                           **kw, table=twin_table) for _ in range(2)]
    assert aw.adamw.uploads == uploads + 2
    torch.cuda.synchronize()
    assert [n.item() for n in norms] == [n.item() for n in twin_norms]
    for a, b in zip(params + ms + vs, sum(twin, [])):
        assert torch.equal(a, b)
    aw.adamw(params, twin_grads, ms, vs, decay, **kw, table=table)
    assert aw.adamw.uploads == uploads + 3
    for _ in range(2):
        aw.adamw(params, twin_grads, ms, vs, decay, **kw)
    assert aw.adamw.uploads == uploads + 5


def test_adamw_update_on_card_never_runs_the_plain_passes(cuda, monkeypatch):
    """``adamw_update`` over CUDA leaves launches the kernel, two launches
    whatever the leaf count, one with a given norm; with the plain version
    broken it still comes right."""
    from repro_torch.kernels.adamw import ops as aw
    from repro_torch.train import optimizer as topt

    def boom(*a, **k):
        raise AssertionError("plain AdamW called for CUDA leaves")

    rng = np.random.default_rng(5)
    params, _, _, _ = _aw_case(cuda, rng, 0.0)
    tree = {f"l{i}": p for i, p in enumerate(params)}
    grads = {k: torch.randn(v.shape, device=cuda) * 3 for k, v in tree.items()}
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=0)
    f = np.float32
    want = [p.clone() for p in params]
    aw.adamw_ref(want, [g.clone() for g in grads.values()],
                 [torch.zeros_like(p) for p in want],
                 [torch.zeros_like(p) for p in want],
                 [cfg.weight_decay * (p.ndim >= 2) for p in want],
                 lr=float(topt.lr_schedule(1, cfg)), beta1=cfg.beta1,
                 beta2=cfg.beta2, bc1=float(f(1) - f(cfg.beta1)),
                 bc2=float(f(1) - f(cfg.beta2)), eps=cfg.eps,
                 clip=cfg.grad_clip)
    monkeypatch.setattr(aw, "adamw_ref", boom)
    monkeypatch.setattr(aw, "global_norm", boom)
    launches = aw.adamw.launches
    state = topt.adamw_init(tree)
    _, state, stats = topt.adamw_update(tree, grads, state, cfg)
    assert aw.adamw.launches == launches + 2
    assert stats["grad_norm"].device.type == "cuda"
    for got, w in zip(tree.values(), want):
        torch.testing.assert_close(got, w, **AW_TOL)
    topt.adamw_update(tree, grads, state, cfg,
                      gnorm=torch.ones((), device=cuda))
    assert aw.adamw.launches == launches + 3
    # a functional collective's result not waited for holds no storage of
    # its own: refused before a launch could read address 0
    from torch.distributed._functional_collectives import (
        AsyncCollectiveTensor)
    grads["l0"] = AsyncCollectiveTensor(grads["l0"])
    with pytest.raises(ValueError, match="no storage"):
        topt.adamw_update(tree, grads, state, cfg)
    assert aw.adamw.launches == launches + 3


def test_trainer_step_two_adamw_launches_and_no_leaf_sized_buffer(
        cuda, monkeypatch):
    """A ``Trainer`` step on the card (grad_accum 2) makes two AdamW
    launches over its 13 leaves, and AdamW allocates less than the largest
    leaf (its plain passes hold two leaf-sized temporaries); the steps
    agree with the same trainer on the CPU, which runs the plain passes."""
    from repro_torch.kernels.adamw import ops as aw
    from repro_torch.train import train_loop
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import Trainer, TrainerConfig
    from repro_torch.tree import to_parameter_dict

    rng = np.random.default_rng(11)
    shapes = [(1 << 22,)] + [(int(n), 3) for n in rng.integers(1, 300, 12)]
    init = {f"w{i:02d}": rng.standard_normal(s).astype(np.float32)
            for i, s in enumerate(shapes)}
    x = rng.standard_normal(8).astype(np.float32)

    def loss_fn(params, batch):
        k = batch["x"].mean()
        return sum(((p * k) ** 2).mean() for p in params.values())

    grown = []
    update = train_loop.adamw_update

    def measured(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = update(*a, **k)
        torch.cuda.synchronize()
        grown.append(torch.cuda.max_memory_allocated() - base)
        return out

    cfg = TrainerConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=0),
                        grad_accum=2)
    runs = {}
    for dev in ("cpu", cuda):
        params = to_parameter_dict({k: torch.tensor(v, device=dev)
                                    for k, v in init.items()})
        runs[str(dev)] = t = Trainer(loss_fn, params, cfg)
        launches = aw.adamw.launches
        if dev != "cpu":
            monkeypatch.setattr(train_loop, "adamw_update", measured)
        for _ in range(3):
            t.run_step({"x": torch.from_numpy(x).to(dev)})
        if dev != "cpu":
            assert aw.adamw.launches == launches + 6
        else:
            assert aw.adamw.launches == launches
    largest = 4 << 22
    assert len(grown) == 3 and max(grown) < largest, grown
    cpu, card = runs["cpu"], runs["cuda"]
    for a, b in zip(card.history, cpu.history):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
    for k in init:
        torch.testing.assert_close(card.params[k].detach().cpu(),
                                   cpu.params[k].detach(), **AW_TOL)
