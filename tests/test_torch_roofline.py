"""The port's roofline (``repro_torch.roofline``) and its dry-run CLI.

* ``MaterializationRoofline``'s byte counts equal the reference's exactly
  over a grid of (B, L, T, fill); its times are those bytes over the H100
  SXM5 constants (PCIe Gen5 x16 for the link, HBM3 for the fused op).
* The step counter, on a program over PyTorch's fake process group with
  known all-reduce, all-gather, reduce-scatter and all-to-all sizes, gives
  the link bytes the reference's ring formulas give for the same
  collectives (``repro.roofline.hlo.parse_collectives`` over the matching
  HLO lines).
* A step's compulsory bytes read each input once (a table only gathered
  from, the rows gathered; one only scattered into, the rows written) and
  write each output once (an input updated in place and returned, what the
  step wrote into it), whatever ops the step reads them with, and the
  floor is those bytes and the model FLOPs over the H100 constants; so for
  a SMOKE LM decode cell and a SMOKE GNN train cell; on the 16x16 fake
  mesh a zoo cell's collectives (a FULL-width prefill's all-reduces, KV
  gathers and cache all-to-alls) are counted by those formulas, and a
  decode cell's compulsory bytes are its rank's blocks.
* ``python -m repro_torch.launch.dryrun`` traces one FULL cell to ``ok`` in
  a subprocess and writes only the results file it is given.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro.roofline import analysis as JA
from repro.roofline.hlo import parse_collectives
from repro_torch.roofline import analysis as TA
from repro_torch.roofline.step_counts import count_step

REPO = Path(__file__).resolve().parent.parent
GRID = [(b, l, t, fill) for b in (1, 32, 1024) for l in (100, 2048)
        for t in (1, 4) for fill in (0.0, 0.37, 1.0)]


@pytest.mark.parametrize("b,l,t,fill", GRID)
def test_materialization_roofline_bytes_equal_reference(b, l, t, fill):
    rows = int(b * l * fill)
    got = TA.materialization_roofline(b, l, t, rows, table_dim=64)
    want = JA.materialization_roofline(b, l, t, rows, table_dim=64)
    for key in ("dense_h2d_bytes", "compact_h2d_bytes", "fused_hbm_bytes",
                "staged_hbm_bytes", "fill", "h2d_savings"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.t_h2d_dense == got.dense_h2d_bytes / 64e9
    assert got.t_h2d_compact == got.compact_h2d_bytes / 64e9
    assert got.t_fused == got.fused_hbm_bytes / 3.35e12
    assert got.t_staged == got.staged_hbm_bytes / 3.35e12
    assert set(got.to_dict()) == set(want.to_dict())


def test_roofline_terms_use_the_h100_constants():
    r = TA.from_compiled("a", "s", "pod", 256,
                         {"flops": 989.4e12, "bytes accessed": 6.7e12},
                         900e9, {"all-reduce": 1}, 256 * 989.4e12)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 2.0)
    assert r.bottleneck == "memory" and r.roofline_fraction == 0.5
    want = JA.from_compiled("a", "s", "pod", 256, {"flops": 1.0}, 0.0, {}, 1.0)
    assert set(r.to_dict()) == set(want.to_dict())
    assert (TA.PEAK_FLOPS, TA.HBM_BW, TA.LINK_BW, TA.H2D_BW) == (
        989.4e12, 3.35e12, 450e9, 64e9)


@pytest.fixture
def fake_mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def test_collective_counts_follow_the_reference_ring_formulas(fake_mesh):
    group = fake_mesh.get_group("model")              # 4 ranks

    def program(x, y):
        funcol.all_reduce(x, "sum", group)                    # f32[8,16]
        funcol.all_gather_tensor(x, 0, group)                 # f32[32,16]
        funcol.reduce_scatter_tensor(y, "sum", 0, group)      # f32[8,16]
        funcol.all_to_all_single(x, None, None, group)        # f32[8,16]
        funcol.all_reduce(x[:2].to(torch.bfloat16), "sum", group)  # bf16[2,16]

    counts = count_step(program, torch.ones(8, 16), torch.ones(32, 16))
    hlo = "\n".join(
        f"  %c{i} = {res} {op}({arg} %p), replica_groups={{{{0,1,2,3}}}}"
        for i, (res, op, arg) in enumerate([
            ("f32[8,16]{1,0}", "all-reduce", "f32[8,16]{1,0}"),
            ("f32[32,16]{1,0}", "all-gather", "f32[8,16]{1,0}"),
            ("f32[8,16]{1,0}", "reduce-scatter", "f32[32,16]{1,0}"),
            ("f32[8,16]{1,0}", "all-to-all", "f32[8,16]{1,0}"),
            ("bf16[2,16]{1,0}", "all-reduce", "bf16[2,16]{1,0}")]))
    want = parse_collectives(hlo)
    got = counts.collectives
    assert got.counts == want.counts
    assert got.result_bytes == want.result_bytes
    assert got.link_bytes == pytest.approx(want.link_bytes, rel=1e-12)
    assert set(got.to_dict()) == set(want.to_dict())
    # one matmul: 2*M*N*K flops; its bytes are inputs + output
    mm = count_step(lambda a, b: a @ b, torch.ones(8, 16), torch.ones(16, 4))
    assert mm.flops == 2 * 8 * 16 * 4
    assert mm.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    # a gather reads the rows it returns, not the table: 2 * out + indices
    ids = torch.tensor([3, 7, 7], dtype=torch.int32)
    g = count_step(lambda t, i: t[i], torch.ones(1000, 16), ids)
    assert g.flops == 0 and g.bytes == 2 * 3 * 16 * 4 + 3 * 4
    # an in-place scatter reads indices and values and writes their rows
    sc = count_step(lambda t, i, v: t.index_put_((i,), v, accumulate=True),
                    torch.zeros(1000, 16), ids, torch.ones(3, 16))
    assert sc.bytes == 2 * (3 * 4 + 3 * 16 * 4)


F32 = 4


@pytest.mark.parametrize("case", ["matmul", "two-gathers", "view",
                                  "dense-and-gather", "scatter",
                                  "in-place-whole", "fake"])
def test_compulsory_bytes_read_inputs_once_and_write_outputs_once(case):
    table, ids = torch.ones(1000, 16), torch.tensor([3, 7, 7])
    rows = 3 * 16 * F32
    if case == "matmul":         # both inputs read once, the output written
        got = count_step(lambda a, b: (a @ b).relu() @ b.T,
                         torch.ones(8, 16), torch.ones(16, 16))
        want = F32 * (8 * 16 + 16 * 16 + 8 * 16)
        assert got.bytes > want        # the eager program moves more
    elif case == "two-gathers":  # each gather charges its rows
        got = count_step(lambda t, i: t[i] + t[i[:1]].sum(), table, ids)
        want = rows + 16 * F32 + 3 * 8 + rows
    elif case == "view":         # a view of an input is that input
        got = count_step(lambda t: t.T @ t[:, :2], table)
        want = 1000 * 16 * F32 + 16 * 2 * F32
    elif case == "dense-and-gather":   # read whole once: capped at its size
        got = count_step(lambda t, i: t[i].sum() + t.sum(), table, ids)
        want = 1000 * 16 * F32 + 3 * 8 + F32
    elif case == "scatter":      # in place: the rows read and written
        got = count_step(lambda t, i, v: t.index_add_(0, i, v),
                         torch.zeros(1000, 16), ids, torch.ones(3, 16))
        want = rows + 3 * 8 + rows + rows
    elif case == "in-place-whole":   # updated whole in place: written whole
        got = count_step(lambda t: t.mul_(2), table.clone())
        want = 2 * 1000 * 16 * F32
    else:                        # fake tensors count as real ones
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            got = count_step(lambda t, i: t[i], torch.empty(1000, 16),
                             torch.empty(3, dtype=torch.int64))
        want = rows + 3 * 8 + rows
    assert got.compulsory_bytes == want


def test_compulsory_floor_is_those_bytes_and_model_flops_at_h100_rates():
    f = TA.compulsory_floor(6.7e12, 4 * 989.4e12, 2)
    assert (f["t_memory_s"], f["t_compute_s"]) == (2.0, 2.0)
    assert f["t_bound_s"] == 2.0 and f["compulsory_bytes_per_chip"] == 6.7e12
    f = TA.compulsory_floor(3.35e12, 989.4e12 * 4, 1)
    assert f["bottleneck"] == "compute" and f["t_bound_s"] == 4.0


def test_dryrun_cli_traces_a_full_cell_and_writes_only_its_results(tmp_path):
    out = tmp_path / "results" / "dryrun_results_torch.json"
    out.parent.mkdir()
    before = {p: p.stat().st_mtime for p in (
        REPO / "dryrun_results.json", REPO / "dryrun_results_torch.json")
        if p.exists()}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    # below the test workers' CPU priority, as the rank processes of
    # test_torch_distributed.py are
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "dlrm-uih", "--shape", "serve_p99", "--mesh", "pod", "--out",
         str(out)], capture_output=True, text=True, timeout=300, env=env,
        cwd=tmp_path, preexec_fn=lambda: os.nice(10))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert list(out.parent.iterdir()) == [out]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["results"]
    after = {p: p.stat().st_mtime for p in (
        REPO / "dryrun_results.json", REPO / "dryrun_results_torch.json")
        if p.exists()}
    assert after == before
    entry = json.loads(out.read_text())["dlrm-uih|serve_p99|pod"]
    assert entry["ok"] and entry["chips"] == 256 and entry["kind"] == "serve"
    assert entry["cost"]["flops"] > 0 and entry["cost"]["bytes accessed"] > 0
    assert entry["collectives"]["counts"]["all-reduce"] >= 1
    assert entry["memory"]["args_logical_bytes_per_chip"] > 0
    assert entry["roofline"]["bottleneck"] in ("compute", "memory",
                                               "collective")
    # the floor of the step's math sits under the eager program's traffic
    floor = entry["floor"]
    assert 0 < floor["compulsory_bytes_per_chip"] <= (
        entry["cost"]["bytes accessed"])
    assert 0 < floor["t_bound_s"] <= entry["roofline"]["t_memory_s"]


def _nbytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("arch,shape", [("qwen3-4b", "decode_32k"),
                                        ("meshgraphnet", "molecule")])
def test_zoo_cell_floor_reads_inputs_once_and_writes_outputs_once(arch,
                                                                  shape):
    """A SMOKE LM decode cell's compulsory bytes: every input once (of the
    embedding table, the rows its tokens gather), the logits written and,
    in the KV cache it updates in place, one entry a row and layer. A SMOKE
    GNN train cell's: every input once (the
    parameters, both moments, the step and the graph) and its outputs
    written once (the parameters and moments updated in place, the step,
    the loss and the gradient norm). The floor is those bytes and the
    model FLOPs over the H100 constants."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sampling import sample_args
    from repro_torch.launch.steps import build_cell

    spec = get_arch(arch)
    mesh = make_test_mesh(1, "cpu")
    try:
        cell = build_cell(spec, shape, mesh, use_full=False)
        args = sample_args(cell, spec.family, seed=0, device="cpu")
        inputs = _nbytes(args)
        counts = count_step(cell.step_fn, *args)
    finally:
        dist.destroy_process_group()
    cfg = cell.meta["cfg"]
    if cell.kind == "decode":
        params, cache, batch = args
        embed = params["embed"]
        b = batch["token"].shape[0]
        rows = b * embed.shape[1] * embed.element_size()
        logits = b * cfg.vocab * cfg.compute_dtype.itemsize
        entries = sum(c[:, :, 0].numel() * c.element_size()
                      for c in cache.values())
        want = inputs - _nbytes(embed) + rows + logits + entries
    else:
        params, opt_state, _ = args
        want = inputs + _nbytes((params, opt_state.m, opt_state.v)) + 3 * F32
    assert counts.compulsory_bytes == want
    floor = TA.compulsory_floor(counts.compulsory_bytes, cell.model_flops, 1)
    assert floor["t_bound_s"] == max(want / 3.35e12,
                                     cell.model_flops / 989.4e12)
    assert counts.bytes >= want          # the eager program moves more


def test_zoo_collectives_and_floor_on_the_pod():
    """Rank 0's program of FULL Qwen3-4B cut to one layer on the 16x16
    fake mesh. Prefill: one all-reduce for the embedding and one for each
    of the attention's and the MLP's row-parallel outputs; k and v each
    gathered from the 2 ranks that share a KV head (8 heads over 16 model
    ranks) and re-blocked by position with an all-to-all over ``model``;
    every result's bytes and ring-model link bytes as
    ``roofline.step_counts.link_bytes`` gives them. Decode: the compulsory
    bytes are this rank's blocks (its weight block and its cache block of
    positions) read once, of its embedding rows the ones its tokens
    gather, and what it writes: its logits block and, in its cache block,
    one entry a row and layer."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline.step_counts import link_bytes
    from repro_torch.tree import tree_leaves

    spec = get_arch("qwen3-4b")
    cfg = dataclasses.replace(spec.full, n_layers=1)
    mesh = make_production_mesh()
    try:
        pre = build_cell(spec, "prefill_32k", mesh, cfg_override=cfg)
        got = dryrun.trace_cell(pre, mesh)["counts"].collectives
        b, s, d = 32 // 16, 32_768, cfg.d_model
        bf16 = 2
        cols = cfg.n_kv_heads * cfg.head_dim // 16          # this rank's
        want = {"all-reduce": [(b * s * d * bf16, 16)] * 3,
                "all-gather": [(b * s * 2 * cols * bf16, 2)] * 2,
                "all-to-all": [(b * s * cols * bf16, 16)] * 2}
        assert got.counts == {k: len(v) for k, v in want.items()}
        assert got.result_bytes == {k: sum(n for n, _ in v)
                                    for k, v in want.items()}
        assert got.link_bytes == pytest.approx(sum(
            link_bytes(op, n, g) for op, v in want.items() for n, g in v),
            rel=1e-12)

        dec = build_cell(spec, "decode_32k", mesh, cfg_override=cfg)
        with FakeTensorMode():
            args = dryrun._local_args(dec, mesh)
            counts = count_step(dec.step_fn, *args)
        params, cache, batch = args
        rows = 128 // 16                                    # this rank's
        embed = params["embed"]
        inputs = _nbytes(args) - _nbytes(embed) + rows * d * bf16
        logits = rows * cfg.vocab // 16 * bf16
        entries = sum(c[:, :, 0].numel() * c.element_size()
                      for c in cache.values())
        assert counts.compulsory_bytes == inputs + logits + entries
        blocks = sum(math.prod(SH.local_shape(l.shape, sp, mesh))
                     * l.dtype.itemsize for l, sp in zip(
                         tree_leaves(dec.args_spec),
                         tree_leaves(dec.in_shardings, is_leaf=SH.is_spec)))
        assert _nbytes(args) == blocks == dryrun._logical_bytes(dec, mesh)
    finally:
        dist.destroy_process_group()
