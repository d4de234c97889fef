"""``launch.procmesh.ProcessMesh``: a (2, 2) ``("data", "model")`` mesh of 4
rank processes over gloo, on the CPU, and train cells' rank-local steps on
it (``testing.mesh_train``) against one rank and the JAX reference.

Every mesh here has a time limit (``TIMEOUT_S``); its rank processes run
below the test workers' priority (``mesh_train.lower_priority``), as the
rank processes of ``tests/test_torch_distributed.py`` do. The train cells
run SMOKE widths in float32 with every table the lookups read at 8,192
rows, so the placement rule row-shards it over ``model`` as at FULL (the
cell-placed feed test of ``tests/test_torch_distributed.py`` does the
same), a batch of 8 (LM: 2 sequences of 32 tokens) and 2 AdamW steps on
one batch. Tolerances: ``rtol = atol = 1e-5`` for the global loss and
gradient norm, and ``1e-5`` relative Frobenius for every leaf's parameter
and first-moment block (float32: the same math summed in another order);
the step-1 loss against the JAX reference's ``make_train_step`` within
``1e-5``.

The same checks on CUDA tensors, over ranks that share the card, are in
``tests/test_torch_process_mesh_gpu.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import recsys as JR
from repro.train import optimizer as JO
from repro_torch import interop
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.procmesh import ProcessMesh
from repro_torch.launch.sampling import sample_args
from repro_torch.testing import mesh_train as MT
from repro_torch.tree import tree_map

TIMEOUT_S = 300
TOL = 1e-5
SHAPE = (2, 2)
# SMOKE widths, float32, tables the rule row-shards, a small batch
CELLS = {
    "dlrm-uih": ("train_batch", {"batch": 8, "item_vocab": 8192,
                                 "field_vocab": 8192}),
    "dcn-v2": ("train_batch", {"batch": 8, "field_vocab": 8192}),
    "qwen3-4b": ("train_4k", {"batch": 2, "seq_len": 32, "vocab": 176}),
}


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _mesh(timeout: float = TIMEOUT_S) -> ProcessMesh:
    return ProcessMesh(SHAPE, device_type="cpu", timeout=timeout)


@pytest.fixture(scope="module")
def pm():
    with _mesh() as mesh:
        mesh.run(MT.lower_priority, 10)
        yield mesh


def test_run_returns_rank_order_and_reuses_its_processes():
    with _mesh() as mesh:
        mesh.run(MT.lower_priority, 10)
        first = mesh.run(MT.whoami, "a", 1)
        second = mesh.run(MT.whoami)
    assert [r[0] for r in first] == [0, 1, 2, 3]
    # rank = data * 2 + model, row-major as the reference lays it out
    assert [r[2:4] for r in first] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r[4] == ("a", 1) for r in first)
    pids = [r[1] for r in first]
    assert [r[1] for r in second] == pids
    assert len(set(pids)) == 4 and os.getpid() not in pids
    assert all(_gone(p) for p in pids)


def test_a_rank_that_raises_makes_run_raise_and_closes_the_mesh():
    with _mesh() as mesh:
        mesh.run(MT.lower_priority, 10)
        pids = [r[1] for r in mesh.run(MT.whoami)]
        with pytest.raises(RuntimeError, match="rank 2 of 4 failed"):
            mesh.run(MT.fail_on, 2)
        with pytest.raises(RuntimeError, match="the mesh is closed"):
            mesh.run(MT.whoami)
    assert all(_gone(p) for p in pids)


def test_a_rank_past_the_timeout_raises_timeout_error():
    with _mesh() as mesh:
        mesh.run(MT.lower_priority, 10)
        pids = [r[1] for r in mesh.run(MT.whoami)]
        mesh.timeout = 3.0
        with pytest.raises(TimeoutError, match="1 rank processes did not"):
            mesh.run(MT.sleep_on, 1, 600.0)
    assert all(_gone(p) for p in pids)


def test_collectives_agree_with_every_rank_computing_alone(pm):
    for errs in pm.run(MT.collectives_on_rank):
        assert len(errs) == 12
        assert max(errs.values()) == 0.0, errs


def _one_rank(arch: str, params=None):
    """(params, batch, reference steps) of ``arch``'s cell on one rank."""
    shape, reduced = CELLS[arch]
    cell = MT.build_train_cell(arch, shape, reduced, make_test_mesh(1, "cpu"),
                               smoke=True)
    family = "lm" if arch == "qwen3-4b" else "recsys"
    sampled, _, batch = sample_args(cell, family, seed=0, device="cpu")
    params = sampled if params is None else params
    params = tree_map(lambda t: t.detach(), params)
    return params, batch, MT.reference_steps(cell, params, [batch, batch])


def _check(got: list, ref: list) -> None:
    for rank, r in enumerate(got):
        assert len(r["steps"]) == 2
        for i, (s, w) in enumerate(zip(r["steps"], ref)):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(s[k], w[k], rtol=TOL, atol=TOL,
                                           err_msg=f"rank {rank} step {i} {k}")
            for k in ("params", "m"):
                worst = max(s[k], key=s[k].get)
                assert s[k][worst] <= TOL, (rank, i, k, worst, s[k][worst])
        assert r["peak"] == 0      # no card
        assert not any(r["launches"].values())


@pytest.mark.parametrize("arch", list(CELLS))
def test_rank_local_train_steps_equal_one_rank(pm, arch):
    """Two AdamW steps of the cell's rank-local program on 4 rank processes
    (row-sharded tables or tensor-parallel weights, ZeRO moments,
    collectives in the backward) against the cell's one-rank steps on the
    same parameters and batch."""
    params, batch, ref = _one_rank(arch)
    shape, reduced = CELLS[arch]
    got = MT.train_on_mesh(pm, arch, shape, reduced, [params, batch], ref,
                           smoke=True)
    _check(got, ref)


def test_rank_local_dlrm_uih_loss_equals_the_jax_reference(pm):
    """The 4 ranks' step-1 global loss of SMOKE DLRM-UIH on the reference's
    parameters (through ``interop``) and batch against the reference's
    ``make_train_step`` loss."""
    shape, reduced = CELLS["dlrm-uih"]
    _, cfg = MT.cell_spec("dlrm-uih", shape, reduced, smoke=True)
    jcfg = JR.DLRMUIHConfig(
        name="t", seq_len=cfg.seq_len, d_seq=cfg.d_seq,
        n_seq_layers=cfg.n_seq_layers, n_heads=cfg.n_heads,
        n_dense=cfg.n_dense, n_sparse=cfg.n_sparse, embed_dim=cfg.embed_dim,
        item_vocab=cfg.item_vocab, field_vocab=cfg.field_vocab,
        top_mlp=cfg.top_mlp, compute_dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, JR.init_dlrm_uih(jax.random.PRNGKey(0),
                                                    jcfg))
    params = interop.dlrm_uih_params_from_numpy(tree, cfg, "cpu")
    params, batch, ref = _one_rank("dlrm-uih", params)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    step = JO.make_train_step(lambda p, b: JR.dlrm_uih_loss(p, b, jcfg),
                              JO.AdamWConfig())
    _, _, want = step(jax.tree.map(jnp.asarray, tree),
                      JO.adamw_init(jax.tree.map(jnp.asarray, tree)), jbatch)
    got = MT.train_on_mesh(pm, "dlrm-uih", shape, reduced, [params, batch],
                           ref, smoke=True)
    for r in got:
        np.testing.assert_allclose(r["steps"][0]["loss"], float(want["loss"]),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ref[0]["loss"], float(want["loss"]),
                               rtol=TOL, atol=TOL)
