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
