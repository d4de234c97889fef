"""The port's launch layer (``repro_torch.configs``, ``launch.{mesh,
shardings,steps,sampling,dryrun}``) against the JAX reference's.

* The registry and the shape tables equal the reference's: every id
  resolves, in the same order, to the same spec.
* Each of the 44 (arch x shape) cells at SMOKE on a one-device mesh (the
  20 recsys cells, and the 24 LM/GNN zoo cells): kind, meta and
  ``model_flops`` exactly, ``args_spec`` leaf for leaf, ``sample_args``
  batches byte for byte (seeds 0 and 1), and ``step_fn``'s outputs against
  the reference's ``jax.jit(cell.step_fn)`` run on the reference's
  parameters (handed over through ``interop``), float32 on the CPU at
  ``rtol=1e-4, atol=1e-5`` for forward values as
  ``tests/test_torch_tenants.py`` holds the same functions, and ``rtol=1e-3``
  for an LM/GNN train step's parameters and moments (as
  ``tests/test_torch_zoo.py``). The reference's MoE train and prefill cells
  fail on a jax mesh (a reference fault): those two kinds are held against its
  model functions with ``mesh=None``. The MoE cells run at a capacity no
  pair exceeds, as in ``tests/test_torch_zoo.py``: where pairs overflow, the
  reference's dispatch clobbers a kept slot.
* A zoo cell builds on the 16x16 production mesh, and its rank-local step
  traces there on fake tensors (FULL width, one layer).
* On the 16x16 and 2x16x16 production meshes: every FULL tenant's parameter
  and optimizer-state placements equal the reference's ``P`` leaf for leaf
  (the zoo's train placements, and the MoE decode cells' ``2d`` expert
  layout, too), and all 44 cells' per-chip logical input bytes equal the
  reference's. The
  reference side runs in a subprocess that forces 512 host devices, as
  ``tests/test_distributed.py`` does; the port side joins PyTorch's fake
  process group, torn down after each test.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as j_base
from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.launch.mesh import make_test_mesh as j_test_mesh
from repro.launch.mesh import set_mesh as j_set_mesh
from repro.launch.sampling import sample_args as j_sample_args
from repro.launch.steps import build_cell as j_build_cell
from repro.models import transformer as JT
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import make_train_step as j_make_train_step
from repro_torch import interop
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs import base as t_base
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.sampling import sample_args
from repro_torch.launch.steps import build_cell
from repro_torch.train.optimizer import adamw_init
from repro_torch.tree import tree_leaves, tree_map

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-5)
RECSYS = [a for a in list_archs() if get_arch(a).family == "recsys"]
CELLS = [(a, s) for a in list_archs() for s in get_arch(a).shapes]
IDS = [f"{a}-{s}" for a, s in CELLS]
RECSYS_CELLS = [(a, s) for a, s in CELLS if a in RECSYS]
RECSYS_IDS = [f"{a}-{s}" for a, s in RECSYS_CELLS]
ZOO = [a for a in list_archs() if a not in RECSYS]
ZOO_CELLS = [(a, s) for a, s in CELLS if a in ZOO]
ZOO_IDS = [f"{a}-{s}" for a, s in ZOO_CELLS]
MOE = [a for a in ZOO if getattr(get_arch(a).full, "moe", None) is not None]
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
TO_PORT = {"two-tower-retrieval": interop.two_tower_params_from_numpy,
           "dcn-v2": interop.dcn_v2_params_from_numpy,
           "dien": interop.dien_params_from_numpy,
           "bert4rec": interop.bert4rec_params_from_numpy,
           "dlrm-uih": interop.dlrm_uih_params_from_numpy,
           "meshgraphnet": interop.meshgraphnet_params_from_numpy}
for _a in list_archs():
    if get_arch(_a).family == "lm":
        TO_PORT[_a] = interop.transformer_params_from_numpy


@pytest.fixture
def one_device_mesh():
    """The port's 1x1 test mesh (a one-rank fake group, destroyed after)."""
    mesh = make_test_mesh(1, "cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture
def production():
    """A function building the port's production mesh by name; the fake
    process group is destroyed after the test."""
    yield lambda name: make_production_mesh(multi_pod=(name == "multipod"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _no_drops(cfg):
    """An MoE config at a capacity of at least T per expert."""
    if getattr(cfg, "moe", None) is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def _cells(arch, shape, mesh):
    jspec, tspec = j_get_arch(arch), get_arch(arch)
    jc = j_build_cell(jspec, shape, j_test_mesh(1), use_full=False,
                      cfg_override=_no_drops(jspec.smoke))
    return jc, build_cell(tspec, shape, mesh, use_full=False,
                          cfg_override=_no_drops(tspec.smoke))


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# registry and shape tables
# ---------------------------------------------------------------------------

def test_registry_and_shape_tables_equal_the_reference():
    assert t_base.RECSYS_SHAPES == j_base.RECSYS_SHAPES
    assert t_base.LM_SHAPES == j_base.LM_SHAPES
    assert t_base.GNN_SHAPES == j_base.GNN_SHAPES
    assert list_archs() == j_list_archs() and len(list_archs()) == 11
    from repro.configs import ASSIGNED as J_ASSIGNED
    from repro_torch.configs import ASSIGNED
    assert ASSIGNED == J_ASSIGNED
    for a in list_archs():
        t, j = get_arch(a), j_get_arch(a)
        assert (t.arch_id, t.family, t.notes) == (j.arch_id, j.family, j.notes)
        assert t.full.name == j.full.name and t.smoke.name == j.smoke.name
        assert t.shapes == j.shapes
    with pytest.raises(KeyError, match="unknown"):
        get_arch("no-such-arch")


# ---------------------------------------------------------------------------
# the 20 SMOKE cells against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_cell_matches_reference(arch, shape, one_device_mesh):
    jc, tc = _cells(arch, shape, one_device_mesh)
    assert (tc.arch_id, tc.shape_name, tc.kind) == (jc.arch_id, jc.shape_name,
                                                    jc.kind)
    assert tc.model_flops == jc.model_flops
    for key in ("batch", "n_candidates", "tokens", "kv_len", "n_nodes",
                "n_edges"):
        assert tc.meta.get(key) == jc.meta.get(key), key
    assert tc.meta["cfg"].name == jc.meta["cfg"].name
    jl, tl = jax.tree.leaves(jc.args_spec), tree_leaves(tc.args_spec)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert (tuple(j.shape), str(j.dtype)) == (t.shape, _dtype_name(t.dtype))


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_sample_args_batches_are_byte_equal(arch, shape, one_device_mesh):
    jc, tc = _cells(arch, shape, one_device_mesh)
    family = get_arch(arch).family
    for seed in (0, 1):
        ja = j_sample_args(jc, family, seed)
        ta = sample_args(tc, family, seed, device="cpu")
        assert len(ja) == len(ta)
        for i in range(1, len(ja)):
            if tc.kind == "train" and i == 1:      # fresh AdamW moments
                assert int(ta[1].step) == 0
                continue
            jl, tl = jax.tree.leaves(ja[i]), tree_leaves(ta[i])
            assert len(jl) == len(tl)
            for j, t in zip(jl, tl):
                j = np.asarray(j)
                assert j.dtype == t.numpy().dtype and j.shape == t.shape
                assert j.tobytes() == t.numpy().tobytes()


def _close(got, want, **tol):
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _reference_step(arch, jc):
    """The reference's step for cell ``jc``: its jitted ``step_fn`` under
    its mesh, or, for the MoE train and prefill cells that fail on a jax
    mesh, its model functions with ``mesh=None``."""
    cfg = jc.meta["cfg"]
    if getattr(cfg, "moe", None) is not None and jc.kind == "train":
        return jax.jit(j_make_train_step(
            lambda p, b: JT.loss_fn(p, b["tokens"], b["targets"], cfg),
            JAdamW()))
    if getattr(cfg, "moe", None) is not None and jc.kind == "prefill":
        return jax.jit(lambda p, b: JT.prefill(p, b["tokens"], cfg))
    step = jax.jit(jc.step_fn)

    def run(*args):
        with j_set_mesh(j_test_mesh(1)):
            return step(*args)
    return run


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_step_fn_matches_reference(arch, shape, one_device_mesh):
    jc, tc = _cells(arch, shape, one_device_mesh)
    family = get_arch(arch).family
    ja = j_sample_args(jc, family, 0)
    want = _reference_step(arch, jc)(*ja)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), ja[0])
    params = TO_PORT[arch](tree, tc.meta["cfg"], "cpu")
    ta = list(sample_args(tc, family, 0, device="cpu"))
    if tc.kind == "train":
        ta[0], ta[1] = params, adamw_init(params)
    else:           # the reference's serving weights are bf16
        ta[0] = tree_map(lambda p: p.detach().to(torch.bfloat16), params)
    got = tc.step_fn(*ta)
    if tc.kind != "train":
        gl, wl = tree_leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            assert tuple(g.shape) == tuple(w.shape)
            assert torch.isfinite(g.float()).all()
            _close(g, w)
        return
    new_params, opt_state, metrics = got
    j_params, j_opt, j_metrics = want
    tol = TOL if family == "recsys" else GRAD_TOL
    for k in ("loss", "grad_norm", "lr"):
        _close(metrics[k], j_metrics[k])
    assert int(opt_state.step) == int(j_opt.step) == 1
    for a, b in zip(tree_leaves(new_params), jax.tree.leaves(j_params)):
        _close(a, b, **tol)
    for a, b in zip(tree_leaves(opt_state.m), jax.tree.leaves(j_opt.m)):
        _close(a, b, **tol)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-30b-a3b",
                                  "meshgraphnet"])
def test_zoo_cells_build_and_trace_on_the_pod(arch, production):
    """The arch's first cell at FULL width, one layer deep, on the 16x16
    fake mesh: rank 0's step traces on fake tensors of its block shapes,
    with the collectives of its tensor/expert/edge parallelism."""
    spec = get_arch(arch)
    mesh = production("pod")
    cfg = dataclasses.replace(spec.full, n_layers=1)
    cell = build_cell(spec, next(iter(spec.shapes)), mesh, cfg_override=cfg)
    traced = dryrun.trace_cell(cell, mesh)
    coll = traced["counts"].collectives.counts
    assert coll.get("all-reduce", 0) > 0 and traced["peak_bytes"] > 0
    assert coll.get("reduce-scatter", 0) > 0        # ZeRO's gradient blocks
    if spec.family == "lm":
        assert coll.get("all-gather", 0) > 0


# ---------------------------------------------------------------------------
# the production meshes: placements and per-chip logical bytes
# ---------------------------------------------------------------------------

REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json, sys
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_arch, list_archs
    from repro.launch.dryrun import _logical_bytes
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import build_cell

    def entries(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    out = {"specs": {}, "bytes": {}, "specs_2d": {}}
    flat = lambda t: [entries(x) for x in jax.tree.leaves(
        t, is_leaf=lambda x: isinstance(x, P))]
    for mesh_name in ("pod", "multipod"):
        mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"))
        for a in list_archs():
            spec = get_arch(a)
            first = next(iter(spec.shapes))
            for s in spec.shapes:
                cell = build_cell(spec, s, mesh, use_full=True)
                out["bytes"][f"{a}|{s}|{mesh_name}"] = _logical_bytes(cell,
                                                                     mesh)
                if s == first:      # every family's first cell trains
                    pspec, ospec = cell.in_shardings[:2]
                    out["specs"][f"{a}|{mesh_name}"] = {
                        "params": flat(pspec), "m": flat(ospec.m),
                        "v": flat(ospec.v), "step": entries(ospec.step)}
                if s == "decode_32k" and getattr(spec.full, "moe", None):
                    out["specs_2d"][f"{a}|{mesh_name}"] = flat(
                        cell.in_shardings[0])
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_production():
    """The reference's placements and logical bytes on both production
    meshes, from one subprocess with 512 host devices."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    # below the test workers' CPU priority, as the rank processes of
    # test_torch_distributed.py are
    proc = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=REPO, preexec_fn=lambda: os.nice(10))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat_specs(tree):
    return [_entries(s) for s in tree_leaves(tree, is_leaf=SH.is_spec)]


@pytest.mark.parametrize("arch", RECSYS + ZOO)
def test_param_and_opt_placements_equal_the_reference(
        arch, reference_production, production):
    tenant = get_arch(arch)
    for mesh_name in ("pod", "multipod"):
        mesh = production(mesh_name)
        cell = build_cell(tenant, next(iter(tenant.shapes)), mesh,
                          use_full=True)
        assert cell.kind == "train"
        pspec, ospec = cell.in_shardings[:2]
        want = reference_production["specs"][f"{arch}|{mesh_name}"]

        def flat(t):
            return [_entries(s) for s in tree_leaves(t, is_leaf=SH.is_spec)]

        assert flat(pspec) == want["params"], mesh_name
        assert flat(ospec.m) == want["m"] == flat(ospec.v) == want["v"]
        assert _entries(ospec.step) == want["step"] == []
        # the placements name a Shard for exactly the spec's sharded dims
        for spec in tree_leaves(pspec, is_leaf=SH.is_spec):
            places = SH.named(mesh, spec)
            assert len(places) == len(mesh.mesh_dim_names)
            shard_dims = {p.dim for p in places if p.is_shard()}
            assert shard_dims == {d for d in range(len(spec))
                                  if spec.dim_axes(d)}


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_2d_placements_equal_the_reference(
        arch, reference_production, production):
    """The MoE decode cells switch the experts to the ``2d`` layout: E on
    ``model`` and the contraction dims on ``data``."""
    for mesh_name in ("pod", "multipod"):
        mesh = production(mesh_name)
        cell = build_cell(get_arch(arch), "decode_32k", mesh, use_full=True)
        assert cell.meta["cfg"].moe.ep_mode == "2d"
        assert _flat_specs(cell.in_shardings[0]) == \
            reference_production["specs_2d"][f"{arch}|{mesh_name}"]


@pytest.mark.parametrize("arch,shape", RECSYS_CELLS + ZOO_CELLS,
                         ids=RECSYS_IDS + ZOO_IDS)
def test_logical_bytes_per_chip_equal_the_reference(
        arch, shape, reference_production, production):
    for mesh_name in ("pod", "multipod"):
        mesh = production(mesh_name)
        cell = build_cell(get_arch(arch), shape, mesh, use_full=True)
        assert dryrun._logical_bytes(cell, mesh) == \
            reference_production["bytes"][f"{arch}|{shape}|{mesh_name}"]
