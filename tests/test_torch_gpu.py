"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: each test skips without a CUDA card (the kernels have no CPU
mode). This file imports neither jax nor the reference package, so it runs
on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.versioning import TrainingExample
from repro_torch.dpp import device_mat
from repro_torch.dpp.client import RebatchingClient
from repro_torch.dpp.featurize import FeatureSpec, featurize_jagged
from repro_torch.kernels.embedding_bag import ops as eb
from repro_torch.kernels.fused import ops

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
