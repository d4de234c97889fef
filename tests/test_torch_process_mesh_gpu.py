"""``launch.procmesh.ProcessMesh`` on the card: 4 rank processes that share
one CUDA device, their collectives through card buffers they all map.

Marked ``gpu``: each test skips without a CUDA card. Like
``tests/test_torch_gpu.py``, this file imports neither jax nor the
reference package, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_process_mesh_gpu.py

The checks are ``tests/test_torch_process_mesh.py``'s on CUDA tensors:
the ranks' results in rank order from the same processes, a rank that
raises or sleeps past the time limit, each collective kind the train
cells call, and SMOKE train cells' rank-local steps against one rank on
the card (float32, TF32 off: ``rtol = atol = 1e-5`` for the loss and the
gradient norm, ``1e-5`` relative Frobenius a leaf). None of them launches
a kernel of the port.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.procmesh import ProcessMesh
from repro_torch.launch.sampling import sample_args
from repro_torch.testing import mesh_train as MT
from repro_torch.tree import tree_map

pytestmark = pytest.mark.gpu

TIMEOUT_S = 120
TOL = 1e-5
CELLS = {
    "dlrm-uih": ("train_batch", {"batch": 8, "item_vocab": 8192,
                                 "field_vocab": 8192}),
    "dcn-v2": ("train_batch", {"batch": 8, "field_vocab": 8192}),
    "qwen3-4b": ("train_4k", {"batch": 2, "seq_len": 32, "vocab": 176}),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the ranks share the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def pm(cuda):
    with ProcessMesh((2, 2), device_type="cuda", timeout=TIMEOUT_S) as mesh:
        yield mesh


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_run_returns_rank_order_and_reuses_its_processes(pm):
    first = pm.run(MT.whoami, "a")
    second = pm.run(MT.whoami)
    assert [r[0] for r in first] == [0, 1, 2, 3]
    assert [r[2:4] for r in first] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r[1] for r in second] == [r[1] for r in first]
    assert os.getpid() not in [r[1] for r in first]


def test_a_failing_or_late_rank_makes_run_raise(cuda):
    for task, args, error in ((MT.fail_on, (2,), RuntimeError),
                              (MT.sleep_on, (1, 600.0), TimeoutError)):
        with ProcessMesh((2, 2), device_type="cuda",
                         timeout=TIMEOUT_S) as mesh:
            pids = [r[1] for r in mesh.run(MT.whoami)]
            mesh.timeout = 3.0
            with pytest.raises(error):
                mesh.run(task, *args)
        assert all(_gone(p) for p in pids)


def test_each_collective_on_cuda_tensors_over_4_rank_processes(pm):
    for errs in pm.run(MT.collectives_on_rank):
        assert len(errs) == 12
        assert max(errs.values()) == 0.0, errs


@pytest.mark.parametrize("arch", list(CELLS))
def test_rank_local_train_steps_equal_one_rank_on_the_card(pm, cuda, arch):
    shape, reduced = CELLS[arch]
    cell = MT.build_train_cell(arch, shape, reduced, make_test_mesh(1, "cuda"),
                               smoke=True)
    family = "lm" if arch == "qwen3-4b" else "recsys"
    params, _, batch = sample_args(cell, family, seed=0, device=cuda)
    params = tree_map(lambda t: t.detach(), params)
    ref = MT.reference_steps(cell, params, [batch, batch])
    got = MT.train_on_mesh(pm, arch, shape, reduced, [params, batch], ref,
                           smoke=True)
    for rank, r in enumerate(got):
        for i, (s, w) in enumerate(zip(r["steps"], ref)):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(s[k], w[k], rtol=TOL, atol=TOL,
                                           err_msg=f"rank {rank} step {i} {k}")
            for k in ("params", "m"):
                worst = max(s[k], key=s[k].get)
                assert s[k][worst] <= TOL, (rank, i, k, worst, s[k][worst])
        assert r["peak"] > 0
        assert not any(r["launches"].values())
