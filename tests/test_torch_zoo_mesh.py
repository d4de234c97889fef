"""The LM/MoE/GNN zoo's rank-local programs on 4 gloo ranks, on the CPU.

Each test writes numpy inputs (the JAX reference's SMOKE parameters and,
computed here, the reference's outputs) to a temporary directory, starts 4
rank processes of ``RANK_SCRIPT`` that rendezvous through a file store, and
waits for them under a time limit. Every rank holds the global inputs,
cuts its block with ``launch.sampling.local_args`` and runs the cell's
rank-local ``step_fn`` on two meshes, ``(2, 2)`` and ``(1, 4)``
(``("data", "model")``; at ``(1, 4)`` SMOKE's 2 KV heads of 16 split below
a head). Its block of every output is held against the same block of the
one-rank program (the model functions with ``mesh=None``) and of the
reference's:

* train cells: the global loss, the gradient norm, every parameter after
  one AdamW step and its first moment (its clipped gradient, on this
  rank's ZeRO block) against the one-rank step, ``rtol = atol = 1e-5``
  (float32: the same math summed in another order);
* prefill and decode cells (bf16 weights, float32 compute): logits and
  caches against the one-rank program at ``rtol = atol = 1e-5`` and
  against the reference's ``mesh=None`` functions at ``rtol=1e-4,
  atol=1e-5`` (``tests/test_torch_launch.py``'s tolerance for the same
  functions); decode in the ``decode_32k`` layout (batch over ``data``,
  positions over ``model``) and in the batch-1 layout (positions over
  every axis), from a random cache at positions on several ranks' blocks.

The MoE runs at a capacity no pair exceeds (``_no_drops``: where pairs
overflow, the reference's dispatch clobbers a kept slot). The reference's
placement refuses a vocabulary that the ``model`` ranks do not divide, so
each SMOKE vocabulary is rounded up to a multiple of 4.

``test_mesh_programs_equal_the_reference_mesh_program`` holds the port
against the reference's own mesh program: a subprocess with 4 forced host
devices runs the reference's dense ``loss_fn`` and ``moe_ffn`` (FSDP and
``2d``) on a ``(2, 2)`` jax mesh, as ``tests/test_distributed.py`` does,
and the gloo ranks run the port's: the loss within 1e-4, the MoE outputs
within 2e-5.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as j_get_arch
from repro.models import gnn as JG
from repro.models import transformer as JT

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
TIMEOUT_S = 300
SEQ = 64                     # SMOKE's seq_len (min(seq_len, 64))
POSITIONS = (5, 40)          # decode rows' positions: blocks of two ranks
POSITION_1 = 45              # the batch-1 row's position

RANK_SCRIPT = textwrap.dedent('''
    import dataclasses
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh

    check, tmp, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=4)
    data = dict(np.load(f"{tmp}/inputs.npz"))

    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.sampling import local_args
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import gnn as G
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             make_train_step)
    from repro_torch.tree import tree_leaves, tree_map

    def tree_of(prefix):
        tree = {}
        for k, v in data.items():
            if k.startswith(prefix):
                node = tree
                *path, leaf = k[len(prefix):].split("/")
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = v
        return tree

    def t(key):
        return torch.from_numpy(data[key])

    def close(got, want, tol, what, rtol=None):
        np.testing.assert_allclose(
            got.detach().float().numpy(), np.asarray(want, np.float32),
            rtol=tol if rtol is None else rtol, atol=tol, err_msg=what)

    def blocks(got, want, specs, mesh, what, tol=1e-5, rtol=None):
        """This rank's blocks ``got`` against the blocks of ``want``."""
        g, w = tree_leaves(got), tree_leaves(want)
        s = tree_leaves(specs, is_leaf=SH.is_spec)
        assert len(g) == len(w) == len(s), (len(g), len(w), len(s))
        for a, b, sp in zip(g, w, s):
            b = SH.local_block(torch.as_tensor(b).detach(), sp, mesh)
            assert tuple(a.shape) == tuple(b.shape), (what, a.shape, b.shape)
            close(a, b, tol, what, rtol)

    def fresh(x):
        return tree_map(lambda v: v.detach().clone(), x)

    def bf16(params):
        with torch.no_grad():
            return tree_map(lambda p: p.detach().to(torch.bfloat16), params)

    def no_drops(cfg):
        if getattr(cfg, "moe", None) is None:
            return cfg
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))

    REF = dict(rtol=1e-4, tol=1e-5)
    meshes = [init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
              for shape in ((2, 2), (1, 4))]

    if check.startswith("lm-"):
        arch = check[3:]
        spec = get_arch(arch)
        cfg = no_drops(dataclasses.replace(spec.smoke,
                                           vocab=int(data["vocab"])))
        params = interop.transformer_params_from_numpy(tree_of("p/"), cfg,
                                                       "cpu")
        opt = AdamWConfig()
        # the one-rank programs
        tokens, targets = t("tokens"), t("targets")
        one_step = make_train_step(
            lambda p, b: T.loss_fn(p, b["tokens"], b["targets"], cfg), opt)
        batch = {"tokens": tokens, "targets": targets}
        one_p, one_s, one_m = one_step(fresh(params), adamw_init(params),
                                       batch)
        serve = bf16(params)
        with torch.no_grad():
            one_pre = T.prefill(serve, tokens, cfg)
            cache = {k[2:]: t(k) for k in data if k.startswith("c/")}
            step_in = {"token": t("token"), "position": t("position")}
            one_dec = T.decode_step(serve, fresh(cache), step_in["token"],
                                    step_in["position"], cfg)
            cache1 = {k: v[:, :1].clone() for k, v in cache.items()}
            one_dec1 = T.decode_step(serve, fresh(cache1), t("token")[:1],
                                     t("position_1"), cfg)
        close(one_m["loss"], data["want/loss"], 1e-5, "one rank vs the "
              "reference's loss", rtol=1e-4)
        for name, got in (("prefill", one_pre), ("decode", one_dec),
                          ("decode1", one_dec1)):
            ref = [data[f"want/{name}/logits"]] + [
                data[f"want/{name}/cache/{k}"] for k in sorted(cache)]
            for a, b in zip(tree_leaves(got), ref):
                close(a, b, REF["tol"], f"one rank {name} vs the reference",
                      REF["rtol"])

        for mesh in meshes:
            where = f"{tuple(mesh.mesh.shape)} rank {rank}"
            c = build_cell(spec, "train_4k", mesh, use_full=False,
                           cfg_override=cfg)
            args = local_args(c, (fresh(params), adamw_init(params), batch),
                              mesh)
            new_p, state, m = c.step_fn(*args)
            for k in ("loss", "grad_norm"):
                close(m[k], one_m[k], 1e-5, f"train {k} {where}")
            assert int(state.step) == 1
            blocks(new_p, one_p, c.in_shardings[0], mesh,
                   f"train params {where}")
            blocks(state.m, one_s.m, c.in_shardings[1].m, mesh,
                   f"train first moments (the gradients) {where}")
            # serving cells: bf16 weights, float32 compute
            c = build_cell(spec, "prefill_32k", mesh, use_full=False,
                           cfg_override=cfg)
            got = c.step_fn(*local_args(c, (serve, {"tokens": tokens}),
                                        mesh))
            blocks(got, one_pre, c.out_shardings, mesh, f"prefill {where}")
            ref_pre = [data["want/prefill/logits"],
                       {k: data[f"want/prefill/cache/{k}"] for k in cache}]
            blocks(got, ref_pre, c.out_shardings, mesh,
                   f"prefill vs the reference {where}", **REF)
            c = build_cell(spec, "decode_32k", mesh, use_full=False,
                           cfg_override=cfg)
            got = c.step_fn(*local_args(c, (serve, fresh(cache), step_in),
                                        mesh))
            blocks(got, one_dec, c.out_shardings, mesh, f"decode {where}")
            ref_dec = [data["want/decode/logits"],
                       {k: data[f"want/decode/cache/{k}"] for k in cache}]
            blocks(got, ref_dec, c.out_shardings, mesh,
                   f"decode vs the reference {where}", **REF)
            # batch 1: its cell, at the SMOKE length, has the cache's
            # positions over every axis
            seq = next(iter(cache1.values())).shape[2]
            one = dataclasses.replace(spec, shapes={"long_500k": {
                **spec.shapes["long_500k"], "seq_len": seq, "batch": 1}})
            c = build_cell(one, "long_500k", mesh, cfg_override=cfg)
            cache_sh = c.out_shardings[1]
            if mesh.size(0) > 1:   # batch 1 does not split over data
                assert all(sp[2] == ("data", "model")
                           for sp in cache_sh.values())
            got = c.step_fn(*local_args(c, (serve, fresh(cache1), {
                "token": t("token")[:1], "position": t("position_1")}),
                mesh))
            blocks(got, one_dec1, c.out_shardings, mesh,
                   f"decode batch 1 {where}")
            ref1 = [data["want/decode1/logits"],
                    {k: data[f"want/decode1/cache/{k}"] for k in cache}]
            blocks(got, ref1, c.out_shardings, mesh,
                   f"decode batch 1 vs the reference {where}", **REF)

    elif check == "gnn":
        spec = get_arch("meshgraphnet")
        cfg = dataclasses.replace(spec.smoke, d_node_in=int(data["d_feat"]))
        params = interop.meshgraphnet_params_from_numpy(tree_of("p/"), cfg,
                                                        "cpu")
        batch = {k[2:]: t(k) for k in data if k.startswith("b/")}
        one_step = make_train_step(lambda p, b: G.loss_fn(
            p, b["node_feats"], b["edge_feats"], b["senders"],
            b["receivers"], b["targets"], cfg, edge_mask=b["edge_mask"]),
            AdamWConfig())
        one_p, one_s, one_m = one_step(fresh(params), adamw_init(params),
                                       batch)
        close(one_m["loss"], data["want/loss"], 1e-5,
              "one rank vs the reference's loss", rtol=1e-4)
        for mesh in meshes:
            where = f"{tuple(mesh.mesh.shape)} rank {rank}"
            c = build_cell(spec, "full_graph_sm", mesh, use_full=False,
                           cfg_override=cfg)
            args = local_args(c, (fresh(params), adamw_init(params), batch),
                              mesh)
            assert args[2]["senders"].shape[0] * 4 == \\
                batch["senders"].shape[0]
            new_p, state, m = c.step_fn(*args)
            for k in ("loss", "grad_norm"):
                close(m[k], one_m[k], 1e-5, f"train {k} {where}")
            blocks(new_p, one_p, c.in_shardings[0], mesh,
                   f"train params {where}")
            blocks(state.m, one_s.m, c.in_shardings[1].m, mesh,
                   f"train first moments (the gradients) {where}")

    elif check == "reference-mesh":
        mesh = meshes[0]                  # the reference's (2, 2) jax mesh
        cfg = T.TransformerConfig(
            "t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab=96, head_dim=8, qk_norm=True, compute_dtype=torch.float32,
            q_chunk=8, loss_chunk=8)
        params = interop.transformer_params_from_numpy(tree_of("p/"), cfg,
                                                       "cpu")
        pspec = SH.lm_param_specs(params, mesh)
        local = tree_map(lambda x, sp: SH.local_block(x.detach(), sp, mesh),
                         params, pspec)
        rows = SH.P("data", None)
        with torch.no_grad():
            share = T.loss_fn(local, SH.local_block(t("toks"), rows, mesh),
                              SH.local_block(t("tgt"), rows, mesh), cfg,
                              mesh=mesh)
        loss = funcol.all_reduce(share, "sum", dist.group.WORLD)
        assert abs(float(loss) - float(data["want/loss"])) < 1e-4, (
            float(loss), float(data["want/loss"]))
        moe = tree_of("m/")
        mcfg = M.MoEConfig(n_experts=8, top_k=2, d_ff=8, capacity_factor=8.0)
        x = t("x")
        expert = {"fsdp": SH.P("model", None, "data"),
                  "2d": SH.P("model", "data", None)}
        for mode, sp in expert.items():
            mp = {k: torch.from_numpy(v) for k, v in moe.items()}
            mp["w_in"] = SH.local_block(mp["w_in"], sp, mesh)
            mp["w_out"] = SH.local_block(mp["w_out"], sp, mesh)
            c = dataclasses.replace(mcfg, ep_mode=mode)
            if mode == "fsdp":   # the tokens split over data, as shard_map's
                got = M.moe_ffn(mp, SH.local_block(x, rows, mesh), c,
                                mesh=mesh)
                want = SH.local_block(t("want/moe_fsdp"), rows, mesh)
            else:                # every token on every rank
                got = M.moe_ffn(mp, x, c, mesh=mesh, data_axes=())
                want = t("want/moe_2d")
            close(got, want, 2e-5, f"moe {mode} rank {rank}")
    else:
        raise SystemExit(f"unknown check {check}")
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank} {check} OK", flush=True)
''')


def _below_other_tests() -> None:
    """Run a rank process at a lower CPU priority than the test workers, as
    ``tests/test_torch_distributed.py`` does."""
    os.nice(10)


def _run(check: str, tmp_path: Path, inputs: dict) -> None:
    np.savez(tmp_path / "inputs.npz", **inputs)
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-W", "ignore", str(script), check, str(tmp_path),
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO, preexec_fn=_below_other_tests)
        for r in range(WORLD)]
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


def _flat(tree, prefix: str) -> dict:
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            else:
                out[prefix + "/".join(path + [k])] = np.asarray(v)

    walk(tree, [])
    return out


def _lm_cfg(arch: str):
    """SMOKE ``arch``, its vocabulary a multiple of 4, at a capacity no
    MoE pair exceeds."""
    cfg = j_get_arch(arch).smoke
    cfg = dataclasses.replace(cfg, vocab=-(-cfg.vocab // WORLD) * WORLD)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _reference_outputs(name: str, out) -> dict:
    logits, cache = out
    return {f"want/{name}/logits": np.asarray(logits, np.float32),
            **{f"want/{name}/cache/{k}": np.asarray(v, np.float32)
               for k, v in cache.items()}}


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-30b-a3b",
                                  "deepseek-v2-lite-16b"])
def test_lm_cells_on_meshes_equal_one_rank_and_the_reference(arch,
                                                             tmp_path):
    """Train, prefill and decode (both layouts) of SMOKE ``arch`` on the
    (2, 2) and (1, 4) meshes: Qwen3's GQA with qk-norm, Qwen3-MoE's FSDP
    and ``2d`` experts, DeepSeek's MLA with shared experts."""
    cfg = _lm_cfg(arch)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (2, SEQ)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab, (2, SEQ)).astype(np.int32)
    loss = JT.loss_fn(params, jnp.asarray(tokens), jnp.asarray(targets), cfg)
    serve = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
    cache = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
             for k, v in JT.init_kv_cache(cfg, 2, SEQ).items()}
    token = rng.integers(0, cfg.vocab, 2).astype(np.int32)
    position = np.asarray(POSITIONS, np.int32)
    position_1 = np.asarray([POSITION_1], np.int32)
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    pre = jax.jit(lambda p, t: JT.prefill(p, t, cfg))(serve, tokens)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, cfg))
    dec = step(serve, jcache, token, position)
    dec1 = step(serve, {k: v[:, :1] for k, v in jcache.items()}, token[:1],
                position_1)
    _run(f"lm-{arch}", tmp_path, {
        **_flat(jax.tree.map(np.asarray, params), "p/"),
        **{f"c/{k}": v for k, v in cache.items()},
        "vocab": np.asarray(cfg.vocab), "tokens": tokens,
        "targets": targets, "token": token, "position": position,
        "position_1": position_1, "want/loss": np.asarray(loss),
        **_reference_outputs("prefill", pre),
        **_reference_outputs("decode", dec),
        **_reference_outputs("decode1", dec1)})


def test_gnn_train_cell_on_meshes_equals_one_rank(tmp_path):
    """MeshGraphNet's train cell (its 256 SMOKE edges over the 4 ranks,
    nodes whole) on the (2, 2) and (1, 4) meshes against one rank, whose
    loss is held against the reference's."""
    spec = j_get_arch("meshgraphnet")
    d_feat = 8                       # full_graph_sm's, cut as SMOKE cuts it
    cfg = dataclasses.replace(spec.smoke, d_node_in=d_feat)
    params = JG.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    n, e = 64, 256
    batch = {"node_feats": rng.standard_normal((n, d_feat)),
             "edge_feats": rng.standard_normal((e, cfg.d_edge_in)),
             "senders": rng.integers(0, n, e), "receivers":
             rng.integers(0, n, e), "edge_mask": rng.random(e) < 0.9,
             "targets": rng.standard_normal((n, cfg.d_out))}
    batch = {k: (v.astype(np.int32) if v.dtype == np.int64 else
                 v.astype(np.float32) if v.dtype == np.float64 else v)
             for k, v in batch.items()}
    loss = JG.loss_fn(params, *(jnp.asarray(batch[k]) for k in (
        "node_feats", "edge_feats", "senders", "receivers", "targets")),
        cfg, edge_mask=jnp.asarray(batch["edge_mask"]))
    _run("gnn", tmp_path, {
        **_flat(jax.tree.map(np.asarray, params), "p/"),
        **{f"b/{k}": v for k, v in batch.items()},
        "d_feat": np.asarray(d_feat), "want/loss": np.asarray(loss)})


REFERENCE_MESH_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import as_shardings
    from repro.launch.mesh import set_mesh
    from repro.launch.shardings import lm_param_specs
    from repro.models.moe import MoEConfig, init_moe, moe_ffn
    from repro.models.transformer import TransformerConfig, init, loss_fn

    out = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    key = jax.random.PRNGKey(0)
    tc = TransformerConfig("t", n_layers=2, d_model=32, n_heads=4,
                           n_kv_heads=2, d_ff=64, vocab=96, head_dim=8,
                           qk_norm=True, compute_dtype=jnp.float32,
                           q_chunk=8, loss_chunk=8)
    params = init(key, tc)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 96, (4, 16)).astype(np.int32)
    tgt = rng.integers(0, 96, (4, 16)).astype(np.int32)
    pspec = lm_param_specs(params, mesh)
    with set_mesh(mesh):
        f = jax.jit(lambda p, a, b: loss_fn(p, a, b, tc, mesh=mesh),
                    in_shardings=as_shardings(
                        mesh, (pspec, P("data", None), P("data", None))))
        out["want/loss"] = np.asarray(f(params, toks, tgt))
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff=8, capacity_factor=8.0)
    moe = init_moe(key, 16, cfg)
    x = rng.standard_normal((16, 16)).astype(np.float32)
    with set_mesh(mesh):
        for mode in ("fsdp", "2d"):
            c = dataclasses.replace(cfg, ep_mode=mode)
            out[f"want/moe_{mode}"] = np.asarray(jax.jit(
                lambda p, x: moe_ffn(p, x, c, mesh=mesh))(moe, x))

    def walk(node, path, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k], prefix)
            else:
                out[prefix + "/".join(path + [k])] = np.asarray(v)

    walk(params, [], "p/")
    walk(moe, [], "m/")
    np.savez(sys.argv[1], toks=toks, tgt=tgt, x=x, **out)
    print("reference mesh programs OK")
""")


def test_mesh_programs_equal_the_reference_mesh_program(tmp_path):
    """The port's dense loss and MoE (FSDP, ``2d``) on 4 gloo ranks against
    the reference's GSPMD/``shard_map`` programs on a (2, 2) jax mesh."""
    out = tmp_path / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_MESH_SCRIPT, str(out)],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=env,
        cwd=REPO, preexec_fn=_below_other_tests)
    assert proc.returncode == 0, proc.stderr[-3000:]
    _run("reference-mesh", tmp_path, dict(np.load(out)))
