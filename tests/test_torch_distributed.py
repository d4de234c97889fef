"""The port's row-sharded lookups, the mesh-set DLRM-UIH forward and the
cell-placed feed on 4 gloo ranks (a 2x2 ``("data", "model")`` mesh), on the
CPU.

Each test writes its numpy inputs (and the JAX reference's outputs, computed
here) to a temporary directory, starts 4 rank processes of
``RANK_SCRIPT`` that rendezvous through a file store, and waits for all of
them under a time limit. Every rank holds the global inputs, takes its
block, runs the rank-local program and compares its block of the output.

Tolerances: the lookups sum the same float32 rows in another order across
ranks, so ``rtol=atol=1e-6`` (the reference's own check 1 in
``tests/test_distributed.py``); the DLRM-UIH forward with ``mesh`` set
against the forward without, ``rtol=atol=2e-5`` (its check 4).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import embedding as JE
from repro.models import recsys as JR

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
TIMEOUT_S = 300

RANK_SCRIPT = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    check, tmp, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    data = dict(np.load(f"{tmp}/inputs.npz"))

    def block(x, n, i):
        """Block i of n along dim 0."""
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    def close(got, want, tol, what):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=tol, atol=tol, err_msg=what)

    def tiny(arch):
        """A tiny config of ``arch``: (cfg, init, loss, score, the tables
        its lookups read)."""
        from repro_torch.models import recsys as R
        f32 = torch.float32
        return {
            "dlrm-uih": (R.DLRMUIHConfig(
                name="t", seq_len=16, d_seq=16, n_seq_layers=1, n_heads=2,
                n_dense=4, n_sparse=2, embed_dim=8, item_vocab=256,
                field_vocab=64, compute_dtype=f32),
                R.init_dlrm_uih, R.dlrm_uih_loss,
                R.dlrm_uih_score_candidates, ("item_table", "sparse_tables")),
            "two-tower-retrieval": (R.TwoTowerConfig(
                name="t", embed_dim=8, tower_mlp=(16, 8), item_vocab=64,
                user_vocab=32, uih_len=6, compute_dtype=f32),
                R.init_two_tower, R.two_tower_loss,
                R.two_tower_score_candidates, ("item_table", "user_table")),
            "dcn-v2": (R.DCNv2Config(
                name="t", n_dense=4, n_sparse=3, embed_dim=4,
                n_cross_layers=2, mlp=(8, 4), field_vocab=16,
                compute_dtype=f32), R.init_dcn_v2, R.dcn_v2_loss,
                R.dcn_v2_score_candidates, ("embed",)),
            "dien": (R.DIENConfig(
                name="t", embed_dim=4, seq_len=6, gru_dim=8, mlp=(8, 4),
                item_vocab=64, cat_vocab=16, compute_dtype=f32),
                R.init_dien, R.dien_loss, R.dien_score_candidates,
                ("item_table", "cat_table")),
            "bert4rec": (R.BERT4RecConfig(
                name="t", embed_dim=8, n_blocks=1, n_heads=2, seq_len=8,
                item_vocab=64, loss_chunk=4, compute_dtype=f32),
                R.init_bert4rec, R.bert4rec_loss,
                R.bert4rec_score_candidates, ("item_table",)),
        }[arch]

    if check == "lookups":
        from repro_torch.models import embedding as E
        table = torch.from_numpy(data["table"])
        ids, mask = data["ids"], data["mask"]
        local_table = block(table, 2, m)          # P("model", None)
        t_ids, t_mask = torch.from_numpy(block(ids, 2, d)), \\
            torch.from_numpy(block(mask, 2, d))    # P("data", None)
        for combiner in ("sum", "mean"):
            got = E.bag_rowsharded(local_table, t_ids, t_mask, combiner, mesh)
            plain = E.embedding_bag(table, t_ids, t_mask, combiner)
            close(got, plain, 1e-6, f"bag {combiner} vs plain")
            close(got, block(data[f"bag_{combiner}"], 2, d), 1e-6,
                  f"bag {combiner} vs reference")
        got = E.seq_rowsharded(local_table, t_ids, mesh)
        close(got, block(data["seq"], 2, d), 1e-6, "seq vs reference")
        close(got, E.lookup(table, t_ids), 1e-6, "seq vs plain")
        got = E.lookup_rowsharded(local_table, t_ids[:, 0], mesh)
        close(got, block(data["seq"][:, 0], 2, d), 1e-6, "lookup")
        # ids sharded over both axes (the retrieval cells' candidates)
        both = block(block(ids[:, 0], 2, d), 2, m)
        got = E.lookup_rowsharded(local_table, torch.from_numpy(both), mesh,
                                  data_axes=("data", "model"))
        close(got, block(block(data["seq"][:, 0], 2, d), 2, m), 1e-6,
              "lookup with ids over data x model")
        # gradients: the table's local rows get the global gradient's rows.
        # A rank's loss is its part of the global loss: the bag is
        # replicated over the 2 model ranks, so each takes half its term.
        tab = local_table.clone().requires_grad_(True)
        out = E.bag_rowsharded(tab, t_ids, t_mask, "sum", mesh)
        loss = (out * torch.from_numpy(block(data["cot"], 2, d))).sum() / 2
        loss.backward()
        g = tab.grad.clone()
        dist.all_reduce(g, group=mesh.get_group("data"))
        close(g, block(data["table_grad"], 2, m), 1e-6, "table gradient")

    elif check == "dlrm":
        import dataclasses
        from repro_torch import interop
        from repro_torch.models import recsys as R
        cfg = R.DLRMUIHConfig(name="t", seq_len=16, d_seq=16, n_seq_layers=1,
                              n_heads=2, n_dense=4, n_sparse=2, embed_dim=8,
                              item_vocab=256, field_vocab=64,
                              compute_dtype=torch.float32, remat=False)
        tree = {}
        for k, v in data.items():
            if k.startswith("p/"):
                node = tree
                *path, leaf = k[2:].split("/")
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = v
        params = interop.dlrm_uih_params_from_numpy(tree, cfg, "cpu")
        batch = {k[2:]: torch.from_numpy(v) for k, v in data.items()
                 if k.startswith("b/")}
        with torch.no_grad():
            want = R.dlrm_uih_forward(params, batch, cfg)
            close(want, data["want"], 2e-5, "mesh-free forward vs reference")
            # every table the lookups read holds this model rank's rows
            local = {k: v for k, v in params.items()}
            for k in ("item_table", "sparse_tables"):
                local[k] = block(params[k], 2, m)
            mcfg = dataclasses.replace(cfg, mesh=mesh, data_axes=("data",))
            got = R.dlrm_uih_forward(local, {k: block(v, 2, d)
                                             for k, v in batch.items()}, mcfg)
        close(got, block(want, 2, d), 2e-5, "mesh forward vs mesh-free")

    elif check.startswith("train-"):
        # one cell's AdamW step on the 2x2 mesh (rank-local program:
        # partial-sum gradients reduced over each parameter's replicated
        # axes, ZeRO moments) against the single-device step, twice
        import dataclasses
        from repro_torch.launch import shardings as SH
        from repro_torch.launch.steps import _sharded_train_step
        from repro_torch.models import recsys as R
        from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                                 adamw_init, make_train_step)
        from repro_torch.tree import tree_leaves, tree_map
        arch = check[len("train-"):]
        cfg, init, loss_fn, _, tables = tiny(arch)
        batch = {k[2:]: torch.from_numpy(v) for k, v in data.items()
                 if k.startswith("b/")}
        opt = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                          weight_decay=0.1)
        full = init(cfg, seed=0, device="cpu")
        # every table the lookups read is row-sharded over model (the rule
        # shards only tables of 8192+ rows; these are SMOKE-sized)
        shape = tree_map(lambda t: t, full)
        pspec = SH.recsys_param_specs(shape, mesh)
        pspec = {k: (SH.P("model", None) if k in tables else v)
                 for k, v in pspec.items()}
        ospec = SH.opt_specs(pspec, shape, mesh)
        mcfg = dataclasses.replace(cfg, mesh=mesh, data_axes=("data",))
        local = tree_map(lambda p, sp: SH.local_block(p.detach(), sp, mesh)
                         .clone(), full, pspec, is_leaf=SH.is_spec)
        zeros = lambda sp, p: torch.zeros(SH.local_shape(tuple(p.shape), sp,
                                                         mesh))
        state = AdamWState(step=torch.zeros((), dtype=torch.int32),
                           m=tree_map(zeros, ospec.m, full,
                                      is_leaf=SH.is_spec),
                           v=tree_map(zeros, ospec.v, full,
                                      is_leaf=SH.is_spec))
        step = _sharded_train_step(lambda p, b: loss_fn(p, b, mcfg), opt,
                                   mesh, pspec, ospec)
        ref_step = make_train_step(lambda p, b: loss_fn(p, b, cfg), opt)
        ref_state = adamw_init(full)
        mine = {k: v if k == "neg_ids" else block(v, 2, d)   # P(None)
                for k, v in batch.items()}
        for i in range(2):
            local, state, got = step(local, state, mine)
            full, ref_state, want = ref_step(full, ref_state, batch)
            for k in ("loss", "grad_norm"):
                close(got[k].detach(), want[k].detach(), 1e-5,
                      f"step {i} {k}")
            assert int(state.step) == int(ref_state.step) == i + 1
            specs = tree_leaves(pspec, is_leaf=SH.is_spec)
            for a, b, sp in zip(tree_leaves(local), tree_leaves(full), specs):
                close(a.detach(), SH.local_block(b.detach(), sp, mesh), 1e-5,
                      f"step {i} params")
            specs = tree_leaves(ospec.m, is_leaf=SH.is_spec)
            for a, b, sp in zip(tree_leaves(state.m),
                                tree_leaves(ref_state.m), specs):
                close(a, SH.local_block(b, sp, mesh), 1e-5, f"step {i} m")

    elif check.startswith("score-"):
        # one user against N candidates sharded over data x model (the
        # retrieval cells' layout: data_axes hold every axis) against the
        # single-device score
        import dataclasses
        from repro_torch.launch import shardings as SH
        arch = check[len("score-"):]
        cfg, init, _, score, tables = tiny(arch)
        full = init(cfg, seed=0, device="cpu")
        user = {k[2:]: torch.from_numpy(v)[1:2] for k, v in data.items()
                if k.startswith("b/") and k[2:] not in (
                    "label", "mask_pos", "neg_ids")}
        cands = torch.from_numpy(data["cands"])
        cats = torch.from_numpy(data["cats"])
        local = {k: block(v, 2, m) if k in tables else v
                 for k, v in full.items()}
        mcfg = dataclasses.replace(cfg, mesh=mesh,
                                   data_axes=("data", "model"))
        both = SH.P(("data", "model"))
        mine = [SH.local_block(c, both, mesh) for c in (cands, cats)]
        extra = lambda c: (c[1],) if arch == "dien" else ()
        with torch.no_grad():
            want = score(full, user, cands, *extra((cands, cats)), cfg)
            got = score(local, user, mine[0], *extra(mine), mcfg)
        want = want.reshape(-1)
        close(got.reshape(-1), SH.local_block(want, both, mesh), 1e-5,
              f"{arch} scores")

    elif check in ("feed", "feed-step"):
        import dataclasses
        from repro_torch.configs import get_arch
        from repro_torch.core import events as ev
        from repro_torch.core.projection import TenantProjection
        from repro_torch.core.simulation import ProductionSim, SimConfig
        from repro_torch.data import DatasetSpec, SimSource, open_feed
        from repro_torch.dpp.featurize import FeatureSpec
        from repro_torch.launch.steps import build_recsys_cell

        if check == "feed":
            cfg = None
        else:
            # tables of 8192 rows, so the placement rule row-shards every
            # table the lookups read, as it does at FULL
            from repro_torch.models import recsys as R
            cfg = R.DLRMUIHConfig(
                name="t", seq_len=16, d_seq=16, n_seq_layers=1, n_heads=2,
                n_dense=4, n_sparse=2, embed_dim=8, item_vocab=8192,
                field_vocab=4096, compute_dtype=torch.float32, remat=False)
        cell = build_recsys_cell(get_arch("dlrm-uih"), "train_batch", mesh,
                                 use_full=cfg is not None, cfg_override=cfg)
        sim = ProductionSim(SimConfig(
            stream=ev.StreamConfig(n_users=8, n_items=2_000, days=3,
                                   events_per_user_day_mean=30.0, seed=7),
            stripe_len=16, requests_per_user_day=4, seed=7))
        sim.run_days(2, capture_reference=False)
        traits = ("item_id", "action_type", "timestamp")

        def feed(**kw):
            spec = DatasetSpec(
                tenant=TenantProjection(
                    "dlrm-uih", seq_len=16, feature_groups=("core",),
                    traits_per_group={"core": traits}),
                source=SimSource(min_rows=24), batch_size=8,
                base_batch_size=4, prefetch_depth=2, n_workers=1,
                ordered=True, device_materialize=True,
                features=FeatureSpec(seq_len=16, uih_traits=traits,
                                     candidate_fields=("item_id",),
                                     label_fields=("click",)))
            f = open_feed(spec, sim, device="cpu", **kw)
            try:
                return [b for b in f], f.client_stats.h2d_bytes
            finally:
                f.close(timeout=30.0)

        (plain, plain_h2d), (placed, placed_h2d) = (
            feed(), feed(cell=cell, mesh=mesh))
        assert len(plain) == len(placed) >= 3, (len(plain), len(placed))
        # each rank uploads and densifies only its rows of the payload
        assert 0 < placed_h2d < plain_h2d, (placed_h2d, plain_h2d)
        for a, b in zip(plain, placed):
            assert list(a) == list(b)
            for k in a:
                assert type(b[k]) is torch.Tensor, (k, type(b[k]))
                want = block(a[k], 2, d)
                got = b[k]
                assert got.dtype == want.dtype and got.shape == want.shape
                assert got.numpy().tobytes() == want.numpy().tobytes(), k

        if check == "feed-step":
            # the placed batches drive the cell's rank-local step: two
            # AdamW steps against the single-device step on the whole
            # batches (rtol = atol = 1e-5, the train checks' tolerance)
            from repro_torch.launch import shardings as SH
            from repro_torch.launch.sampling import local_args
            from repro_torch.models import recsys as R
            from repro_torch.train.optimizer import (AdamWConfig,
                                                     adamw_init,
                                                     make_train_step)
            from repro_torch.tree import tree_leaves
            full = R.init_dlrm_uih(cfg, seed=0, device="cpu")
            state = adamw_init(full)
            local, lstate = local_args(
                cell, (full, state), mesh)
            ref_step = make_train_step(
                lambda p, b: R.dlrm_uih_loss(p, b, cfg), AdamWConfig())
            for i, (a, b) in enumerate(zip(plain[:2], placed[:2])):
                local, lstate, got = cell.step_fn(
                    local, lstate, R.dlrm_uih_prep(b, cell.meta["cfg"]))
                full, state, want = ref_step(full, state,
                                             R.dlrm_uih_prep(a, cfg))
                for k in ("loss", "grad_norm"):
                    close(got[k].detach(), want[k].detach(), 1e-5,
                          f"step {i} {k}")
                specs = tree_leaves(cell.in_shardings[0], is_leaf=SH.is_spec)
                for x, y, sp in zip(tree_leaves(local), tree_leaves(full),
                                    specs):
                    close(x.detach(), SH.local_block(y.detach(), sp, mesh),
                          1e-5, f"step {i} params")
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank} {check} OK", flush=True)
''')


def _below_other_tests() -> None:
    """Run a rank process at a lower CPU priority than the test workers:
    four of them at once would otherwise crowd out tests that run beside
    this file and depend on thread timing."""
    os.nice(10)


def _run(check: str, tmp_path: Path, inputs: dict) -> None:
    np.savez(tmp_path / "inputs.npz", **inputs)
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), check, str(tmp_path), str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO, preexec_fn=_below_other_tests) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}\n{err[-3000:]}"
        assert f"rank {r} {check} OK" in out


def test_row_sharded_lookups_equal_unsharded_and_reference(tmp_path):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, 16)).astype(np.float32)
    ids = rng.integers(0, 64, (8, 5)).astype(np.int32)
    mask = rng.random((8, 5)) < 0.8
    cot = rng.standard_normal((8, 16)).astype(np.float32)
    jt, ji, jm = jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask)
    table_grad = jax.grad(lambda t: jnp.sum(
        JE.embedding_bag(t, ji, jm, "sum") * cot))(jt)
    _run("lookups", tmp_path, {
        "table": table, "ids": ids, "mask": mask, "cot": cot,
        "bag_sum": np.asarray(JE.embedding_bag(jt, ji, jm, "sum")),
        "bag_mean": np.asarray(JE.embedding_bag(jt, ji, jm, "mean")),
        "seq": np.asarray(jt[ji]),
        "table_grad": np.asarray(table_grad)})


def test_dlrm_uih_forward_with_mesh_equals_without(tmp_path):
    rc = JR.DLRMUIHConfig(name="t", seq_len=16, d_seq=16, n_seq_layers=1,
                          n_heads=2, n_dense=4, n_sparse=2, embed_dim=8,
                          item_vocab=256, field_vocab=64,
                          compute_dtype=jnp.float32, remat=False)
    tree = jax.tree.map(np.asarray, JR.init_dlrm_uih(jax.random.PRNGKey(0),
                                                    rc))
    rng = np.random.default_rng(1)
    batch = {
        "uih_item_id": rng.integers(0, 256, (8, 16)).astype(np.int32),
        "uih_action_type": rng.integers(0, 16, (8, 16)).astype(np.int32),
        "uih_mask": np.arange(16)[None, :] >= rng.integers(0, 16, 8)[:, None],
        "cand_item_id": rng.integers(0, 256, 8).astype(np.int32),
        "sparse_ids": rng.integers(0, 64, (8, 2)).astype(np.int32),
        "dense": rng.standard_normal((8, 4)).astype(np.float32),
    }
    want = JR.dlrm_uih_forward(tree, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, rc)
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            else:
                flat["p/" + "/".join(path + [k])] = v

    walk(tree, [])
    _run("dlrm", tmp_path, {**flat, **{f"b/{k}": v for k, v in batch.items()},
                            "want": np.asarray(want)})


def test_cell_placed_feed_blocks_equal_the_unsharded_batch(tmp_path):
    _run("feed", tmp_path, {"unused": np.zeros(1)})


def test_cell_placed_feed_drives_the_cells_train_step(tmp_path):
    """The placed feed's batches are what the cell's rank-local step takes:
    a DLRM-UIH train cell with row-sharded tables steps on them as the
    single-device step does on the whole batches."""
    _run("feed-step", tmp_path, {"unused": np.zeros(1)})


def _train_batch(arch: str) -> dict:
    """8 rows of ``arch``'s train inputs (the tiny configs of the rank
    script), each history with at least one valid position."""
    rng = np.random.default_rng(2)

    def mask(s):
        return np.arange(s)[None, :] >= rng.integers(0, s, 8)[:, None]

    label = (rng.random(8) < 0.4).astype(np.float32)
    ids = {"dlrm-uih": 256, "two-tower-retrieval": 64, "dien": 64,
           "bert4rec": 64}.get(arch, 0)
    if arch == "dlrm-uih":
        out = {"uih_item_id": rng.integers(0, ids, (8, 16)),
               "uih_action_type": rng.integers(0, 16, (8, 16)),
               "uih_mask": mask(16), "cand_item_id": rng.integers(0, ids, 8),
               "sparse_ids": rng.integers(0, 64, (8, 2)),
               "dense": rng.standard_normal((8, 4)), "label": label}
    elif arch == "two-tower-retrieval":
        out = {"user_id": rng.integers(0, 32, 8),
               "uih_item_id": rng.integers(0, ids, (8, 6)),
               "uih_mask": mask(6), "cand_item_id": rng.integers(0, ids, 8)}
    elif arch == "dcn-v2":
        out = {"sparse_ids": rng.integers(0, 16, (8, 3)),
               "dense": rng.standard_normal((8, 4)), "label": label}
    elif arch == "dien":
        out = {"uih_item_id": rng.integers(0, ids, (8, 6)),
               "uih_category": rng.integers(0, 16, (8, 6)),
               "uih_mask": mask(6), "cand_item_id": rng.integers(0, ids, 8),
               "cand_category": rng.integers(0, 16, 8), "label": label}
    else:
        m = mask(8)
        out = {"uih_item_id": rng.integers(0, ids, (8, 8)), "uih_mask": m,
               "mask_pos": (rng.random((8, 8)) < 0.4) & m,
               "neg_ids": rng.integers(0, ids, 16)}
    return {f"b/{k}": (v.astype(np.int32) if v.dtype == np.int64 else
                       v.astype(np.float32) if v.dtype == np.float64 else v)
            for k, v in out.items()}


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "dcn-v2", "dien",
                                  "bert4rec", "dlrm-uih"])
def test_sharded_train_step_equals_the_single_device_step(arch, tmp_path):
    """Two AdamW steps of a cell's rank-local program on the 2x2 mesh (row-
    sharded tables, the batch over data x model, ZeRO moments) against the
    single-device step on the whole batch: the global loss and gradient
    norm, each rank's block of the parameters and of the first moment
    (rtol = atol = 1e-5: the same float32 math summed in another order)."""
    _run(f"train-{arch}", tmp_path, _train_batch(arch))


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "dcn-v2", "dien",
                                  "bert4rec", "dlrm-uih"])
def test_sharded_candidate_scores_equal_the_single_device_scores(arch,
                                                                 tmp_path):
    """One user against 16 candidates sharded over data x model (ids
    all-gathered over ``model``, rows reduce-scattered back) against the
    single-device score (rtol = atol = 1e-5)."""
    rng = np.random.default_rng(3)
    vocab = {"dcn-v2": 16, "dlrm-uih": 256}.get(arch, 64)
    _run(f"score-{arch}", tmp_path, {
        **_train_batch(arch),
        "cands": rng.integers(0, vocab, 16).astype(np.int32),
        "cats": rng.integers(0, 16, 16).astype(np.int32)})
