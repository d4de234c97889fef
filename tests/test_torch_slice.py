"""The port's first slice end to end against the JAX reference: a
``ProductionSim`` -> ``open_feed(device_materialize=True)`` -> compact jagged
payloads -> ``DeviceMaterializer`` -> ``Trainer.fit`` on DLRM-UIH SMOKE, from
the same sim seed and the same parameters in both packages.

The model prep runs inside the loss on the device batch (no ``prep_fn``):
a ``prep_fn`` would switch device materialization off in both packages.
The loss trajectory matches within ``rtol=1e-3``: float32 reduction-order
differences compound through AdamW over the steps.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import dlrm_uih as j_cfgs
from repro.models import recsys as JR
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import dlrm_uih as t_cfgs
from repro_torch.interop import dlrm_uih_params_from_numpy
from repro_torch.kernels.fused import ops as tfu
from repro_torch.models import recsys as TR
from repro_torch.train.optimizer import AdamWConfig as TAdamW
from repro_torch.train.train_loop import Trainer as TTrainer
from repro_torch.train.train_loop import TrainerConfig as TTrainerConfig

REPO = Path(__file__).resolve().parent.parent
STEPS = 3
BATCH = 8


def _feed(port: bool, cfg):
    """Sim + spec + open_feed from one package (same seed and knobs)."""
    if port:
        from repro_torch.core import events as ev
        from repro_torch.core.projection import TenantProjection
        from repro_torch.core.simulation import ProductionSim, SimConfig
        from repro_torch.data import DatasetSpec, SimSource, open_feed
        from repro_torch.dpp.featurize import FeatureSpec
    else:
        from repro.core import events as ev
        from repro.core.projection import TenantProjection
        from repro.core.simulation import ProductionSim, SimConfig
        from repro.data import DatasetSpec, SimSource, open_feed
        from repro.dpp.featurize import FeatureSpec
    sim = ProductionSim(SimConfig(
        stream=ev.StreamConfig(n_users=8, n_items=2_000, days=4,
                               events_per_user_day_mean=30.0, seed=7),
        stripe_len=16, requests_per_user_day=4, seed=7))
    sim.run_days(3, capture_reference=False)
    traits = ("timestamp", "item_id", "action_type", "category")
    spec = DatasetSpec(
        tenant=TenantProjection(
            "dlrm-uih", seq_len=cfg.seq_len,
            feature_groups=("core", "sideinfo"),
            traits_per_group={"core": traits[:3], "sideinfo": traits[3:]}),
        source=SimSource(min_rows=(STEPS + 2) * BATCH),
        batch_size=BATCH, base_batch_size=4, prefetch_depth=2,
        n_workers=1, ordered=True, device_materialize=True,
        features=FeatureSpec(seq_len=cfg.seq_len, uih_traits=traits[1:]
                             + ("timestamp",),
                             candidate_fields=("item_id",),
                             label_fields=("click",)))
    if port:
        return open_feed(spec, sim, device="cpu")
    return open_feed(spec, sim)


def _jax_prep(b, cfg):
    """``dlrm_uih_prep``'s transforms in jnp (the reference side)."""
    mask = b["uih_mask"]
    sources = (b["user_id"], b["cand_item_id"])
    return {
        "uih_item_id": (b["uih_item_id"] % cfg.item_vocab).astype(jnp.int32),
        "uih_action_type": (b["uih_action_type"] % 16).astype(jnp.int32),
        "uih_mask": mask,
        "cand_item_id": (b["cand_item_id"] % cfg.item_vocab).astype(
            jnp.int32),
        "sparse_ids": jnp.stack([sources[i % 2] % cfg.field_vocab
                                 for i in range(cfg.n_sparse)],
                                1).astype(jnp.int32),
        "dense": jnp.stack([mask.sum(1)] * cfg.n_dense, 1).astype(
            jnp.float32) / mask.shape[1],
        "label": b["label_click"].astype(jnp.float32),
    }


def test_slice_loss_trajectory_matches_reference():
    j_cfg, t_cfg = j_cfgs.SMOKE, t_cfgs.SMOKE
    init = jax.jit(JR.init_dlrm_uih, static_argnums=1)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), j_cfg))
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=STEPS)

    j_feed = _feed(port=False, cfg=j_cfg)
    jt = JTrainer(lambda p, b: JR.dlrm_uih_loss(p, _jax_prep(b, j_cfg), j_cfg),
                  jax.tree.map(jnp.asarray, tree),
                  JTrainerConfig(opt=JAdamW(**opt), grad_accum=2))
    try:
        jt.fit(j_feed, max_steps=STEPS)
    finally:
        j_feed.close(timeout=10.0)

    t_feed = _feed(port=True, cfg=t_cfg)
    assert t_feed.prefetcher.materialize is not None   # the device path
    launches = tfu.fused_densify.launches
    tt = TTrainer(lambda p, b: TR.dlrm_uih_loss(p, TR.dlrm_uih_prep(b, t_cfg),
                                                t_cfg),
                  dlrm_uih_params_from_numpy(tree, t_cfg, "cpu"),
                  TTrainerConfig(opt=TAdamW(**opt), grad_accum=2))
    try:
        tt.fit(t_feed, max_steps=STEPS)
        h2d = t_feed.client_stats.h2d_bytes
    finally:
        t_feed.close(timeout=10.0)

    assert tfu.fused_densify.launches == launches     # CPU: plain version
    assert h2d > 0
    assert len(tt.history) == len(jt.history) == STEPS
    got = [h["loss"] for h in tt.history]
    want = [h["loss"] for h in jt.history]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose([h["grad_norm"] for h in tt.history],
                               [h["grad_norm"] for h in jt.history], rtol=1e-3)


def test_port_imports_neither_jax_nor_the_reference_package():
    """Every repro_torch module, every example under ``examples_torch/``,
    every module of ``benchmarks_torch`` and chip_smoke.py import with
    ``jax`` and ``repro`` blocked in ``sys.modules``."""
    code = (
        "import sys, pkgutil, importlib, importlib.util, pathlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, benchmarks_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "benches = ['benchmarks_torch'] + [m.name for m in\n"
        "    pkgutil.walk_packages(benchmarks_torch.__path__,\n"
        "                          'benchmarks_torch.')]\n"
        "for n in names + benches:\n"
        "    importlib.import_module(n)\n"
        "examples = sorted(pathlib.Path('examples_torch').glob('*.py'))\n"
        "for path in examples:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        'examples_torch_' + path.stem, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import chip_smoke\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'repro')\n"
        "            and sys.modules[m] is not None]\n"
        "print(len(names), len(examples), len(benches))\n")
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_port, n_examples, n_benches = map(int, out.stdout.split()[-3:])
    assert n_examples == 5 and n_benches == 8
    assert n_port + n_examples + n_benches >= 54


def test_device_prep_matches_the_reference_transforms():
    rng = np.random.default_rng(9)
    cfg = t_cfgs.SMOKE
    b = {"uih_item_id": rng.integers(0, 5_000, (4, cfg.seq_len)),
         "uih_action_type": rng.integers(0, 40, (4, cfg.seq_len)).astype(
             np.int32),
         "uih_mask": rng.random((4, cfg.seq_len)) < 0.5,
         "cand_item_id": rng.integers(0, 5_000, 4),
         "user_id": rng.integers(0, 500, 4),
         "label_click": (rng.random(4) < 0.5).astype(np.float32)}
    got = TR.dlrm_uih_prep({k: torch.from_numpy(v) for k, v in b.items()},
                           cfg)
    want = _jax_prep({k: jnp.asarray(v) for k, v in b.items()}, j_cfgs.SMOKE)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
