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


def test_materializer_on_card_equals_densify_host(cuda):
    rng = np.random.default_rng(24)
    spec = FeatureSpec(seq_len=7, uih_traits=("item_id", "flag", "timestamp"),
                       candidate_fields=("item_id",), label_fields=("click",))
    client = RebatchingClient(8, buffer_batches=64, shuffle_seed=0,
                              emit_jagged=True)
    for k in range(4):
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
    mat = device_mat.DeviceMaterializer(device=cuda)
    payloads = list(client)
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
    then, once in a while all of them: a trace in which no kernel has
    records for half the calls is taken again, up to ``attempts`` traces."""
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
        if any(2 * n >= calls for n in kernels.values()):
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
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert runtime.raw_stream(table) == side.cuda_stream != \
            torch.cuda.default_stream().cuda_stream
        bag = eb.embedding_bag(table, ids, mask, "mean")
        dec = dd.delta_decode(d, d[:, 0])
    side.synchronize()
    torch.testing.assert_close(bag, eb.embedding_bag_ref(table, ids, mask,
                                                         "mean"), **F32)
    assert torch.equal(dec, dd.delta_decode_ref(d, d[:, 0]))


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
