"""A train cell's rank-local steps on a ``ProcessMesh``, held against the
same cell's one-rank steps on the same parameters and batches.

The one-rank side (``reference_steps``) runs the cell built on a one-rank
mesh, whose step is the plain ``make_train_step``, and keeps after each step
the loss, the gradient norm, the parameters and the first moments (in
pinned host memory when asked: a FULL cell's states do not fit the card
beside four rank processes). ``train_on_mesh`` then drives the ranks
through a session each keeps on its mesh: ``rank_start`` builds the same
cell on the rank's mesh with ``launch.steps.build_cell``, so the parameter
and optimizer placements are the cell's own, and cuts the rank's blocks of
the shared parameters and batches (``shardings.local_block(...).clone()``)
and zero moments of its block shapes; ``rank_step`` runs the cell's
``step_fn`` (the rank-local ``_sharded_train_step``: collectives inside
the backward, a reduce-scatter, all-reduces and an all-gather after it)
and hands its live blocks back (a CUDA tensor as an IPC handle, nothing
copied); the caller holds each against the reference's block
(``rel_err``, ``param_err``) before the next step; ``rank_finish`` returns
the rank's peak, its host seconds and the kernels' launches. A DLRM-UIH
cell can take its batches from the cell-placed feed instead, opened in
the rank over a sim built from the same config: each rank then uploads
and densifies only its rows (``fused_densify`` launches in every rank).

Both sides turn TF32 off (per-process flags) and can run under
deterministic kernels (``precision``).

``collectives_on_rank`` checks, on the mesh's device, each collective kind
the train cells call (all-reduce, all-gather, reduce-scatter, all-to-all)
over ``data``, ``model`` and both axes against the values every rank can
compute alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import axes_group, axes_rank, axes_size
from repro_torch.tree import tree_leaves, tree_map

ERR_CHUNK = 1 << 24        # elements a leaf's error is summed over at a time
MOVED = 1e-2               # a parameter element moved by this share of lr:
#                            its Adam direction changed (``param_err``)
ULPS = 4 * 2.0 ** -23      # ... and by more than 4 float32 ulps of its value


@contextlib.contextmanager
def precision(deterministic: bool = False):
    """TF32 off for matmuls and cuDNN (and, if asked, deterministic kernels:
    the MoE combine's ``index_add`` without atomics) while the block runs;
    the process's flags are restored after it."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was[0]
        torch.backends.cudnn.allow_tf32 = was[1]
        torch.use_deterministic_algorithms(was[2], warn_only=was[3])


def cell_spec(arch: str, shape: str, reduced: Dict[str, Any],
              smoke: bool = False):
    """(spec, cfg) of ``arch``'s ``shape`` cell with ``reduced`` applied:
    a key the shape names replaces the shape's entry (batch, seq_len);
    ``capacity_factor`` replaces the MoE's; every other key replaces a
    field of the FULL (or SMOKE) config (n_layers, compute_dtype, a
    vocabulary)."""
    from repro_torch.configs import get_arch

    base = get_arch(arch)
    shp = dict(base.shapes[shape])
    fields = {}
    for k, v in reduced.items():
        if k in shp:
            shp[k] = v
        else:
            fields[k] = v
    cfg = base.smoke if smoke else base.full
    cap = fields.pop("capacity_factor", None)
    cfg = dataclasses.replace(cfg, **fields)
    if cap is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cap))
    return dataclasses.replace(base, shapes={**base.shapes, shape: shp}), cfg


def build_train_cell(arch: str, shape: str, reduced: Dict[str, Any], mesh,
                     smoke: bool = False):
    """``launch.steps.build_cell`` of ``cell_spec``'s cell on ``mesh``, at
    the shape ``reduced`` leaves it (a SMOKE config too: its row-sharded
    lookups, batch placements and losses are those of a FULL cell)."""
    from repro_torch.launch.steps import build_cell

    spec, cfg = cell_spec(arch, shape, reduced, smoke)
    return build_cell(spec, shape, mesh, cfg_override=cfg)


def leaf_names(tree: Any) -> List[str]:
    """The ``/``-joined key paths of ``tree``'s leaves, in
    ``tree_leaves``'s (sorted) order."""
    if isinstance(tree, dict) or hasattr(tree, "keys"):
        return [f"{k}/{n}" if n else str(k) for k in sorted(tree.keys())
                for n in leaf_names(tree[k])]
    return [""]


class HostStates:
    """Page-locked host memory that one-rank states are copied into: one
    allocation registered with CUDA (``cudaHostRegister``) for the card's
    copies to run at the link's rate, made once and reused by every cell
    (``reset``), since faulting in fresh host pages is slower than the
    copies. ``close`` unregisters it."""

    ALIGN = 256

    def __init__(self, nbytes: int):
        self.buf = torch.empty(nbytes, dtype=torch.uint8)
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
            self.buf.data_ptr(), nbytes, 0))
        self.used = 0

    def keep(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` in this memory."""
        n = t.numel() * t.element_size()
        if self.used + n > self.buf.numel():
            raise MemoryError(f"host states: {self.used + n} B needed, "
                              f"{self.buf.numel()} B made")
        out = self.buf[self.used:self.used + n].view(t.dtype).view(t.shape)
        self.used += -(-n // self.ALIGN) * self.ALIGN
        return out.copy_(t)

    def reset(self) -> None:
        self.used = 0

    def close(self) -> None:
        torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(
            self.buf.data_ptr()))


def reference_steps(cell, params, batches: list,
                    host: Optional[HostStates] = None,
                    deterministic: bool = False) -> List[Dict[str, Any]]:
    """The one-rank ``cell``'s AdamW steps under ``precision``, one a
    batch, from ``params`` (a copy: ``params`` are left as they are) and
    zero moments: each step's loss, gradient norm, parameters and first
    moments (copied into ``host`` when given: a FULL cell's states do not
    fit the card beside four rank processes)."""
    from repro_torch.train.optimizer import adamw_init

    def keep(t):
        t = t.detach()
        return t.clone() if host is None else host.keep(t)

    p = tree_map(lambda t: t.detach().clone(), params)
    state = adamw_init(p)
    out = []
    with precision(deterministic):
        for batch in batches:
            t0 = time.perf_counter()
            p, state, metrics = cell.step_fn(p, state, batch)
            loss = float(metrics["loss"])       # waits for the step
            t1 = time.perf_counter()
            out.append({"loss": loss,
                        "grad_norm": float(metrics["grad_norm"]),
                        "params": tree_map(keep, p),
                        "m": tree_map(keep, state.m),
                        "seconds": {"step": t1 - t0,
                                    "keep": time.perf_counter() - t1}})
    return out


def block_slices(shape, spec, mesh) -> List[tuple]:
    """(dim, start, length) of each dim ``shardings.local_block`` narrows
    to cut this rank's block of a tensor of ``shape`` under ``spec``."""
    out = []
    for dim in range(min(len(spec), len(shape))):
        axes = spec.dim_axes(dim)
        if axes:
            n = shape[dim] // axes_size(mesh, axes)
            out.append((dim, axes_rank(mesh, axes) * n, n))
    return out


def _block_rows(base: torch.Tensor, slices, i: int, rows: int, device
                ) -> torch.Tensor:
    """Rows ``[i, i + rows)`` of the block ``slices`` cuts from ``base``,
    on ``device``: whole rows of ``base`` are moved (contiguous, so a
    pinned ``base`` moves at the link's rate) and the other dims are cut
    there."""
    lo = next((s for d, s, _ in slices if d == 0), 0)
    x = base.narrow(0, lo + i, rows).to(device)
    for d, s, n in slices:
        if d > 0:
            x = x.narrow(d, s, n)
    return x.double()


def rel_err(got: torch.Tensor, base: torch.Tensor, slices) -> tuple:
    """(``||got - want|| / ||want||``, ``max |got - want|``) where ``want``
    is the block ``slices`` cuts from ``base`` (any device): Frobenius in
    float64 sums, about ``ERR_CHUNK`` elements (whole rows) at a time; 0
    where both are 0."""
    g = got.detach()
    if g.ndim == 0:
        g, base = g.reshape(1), base.reshape(1)
    rows = max(1, ERR_CHUNK // max(1, g[0].numel()))
    diff = ref = top = 0.0
    for i in range(0, g.shape[0], rows):
        n = min(rows, g.shape[0] - i)
        b = _block_rows(base, slices, i, n, g.device)
        d = g[i:i + n].double() - b
        diff += float(d.square().sum())
        ref += float(b.square().sum())
        top = max(top, float(d.abs().max()))
    if ref == 0.0:
        return (0.0 if diff == 0.0 else math.inf), top
    return math.sqrt(diff / ref), top


def param_err(got: torch.Tensor, base: torch.Tensor, slices, scale,
              dm: float, lr: float, lr_total: float, known: torch.Tensor):
    """A parameter block's error against the reference's (the block
    ``slices`` cuts from ``base``), with the elements whose Adam direction
    flipped set aside and accounted for.

    Adam moves an element by ``lr * m / (sqrt(v) + eps)`` (bias-corrected
    moments): about ``lr`` in the direction of its gradient's sign
    whatever the gradient's size, so where a gradient sums to near zero
    (summed in another order on four ranks) the element can move by up to
    ``2 * lr`` the other way: on a zero-initialised bias of n elements one
    such element alone is a relative error of ``2 / sqrt(n)``. To first
    order a first-moment difference ``dm`` moves the direction by ``dm /
    (sqrt(v) + eps)``. An element moved when it differs by more than
    ``MOVED * lr`` and by more than ``ULPS`` of its value (a hundredth of
    ``lr`` on a weight of 1 is below float32's resolution: two roundings
    of it differ by an ulp). A moved element is explained when, at this
    step or an earlier one (``known``: flat
    indices in the block), ``sqrt(v) + eps`` there (``scale(index)``, the
    ranks' own second moments at the global ``index``) is at most ``dm /
    MOVED``, with ``dm`` the largest bias-corrected first-moment difference
    any rank's block of this leaf has against the reference (held to 1e-3
    relative on its own). Returns (relative Frobenius error, the same
    without the explained elements, the explained indices, how many moved
    elements are not explained, the largest explained move in units of
    the steps' summed ``lr``)."""
    g = got.detach()
    if g.ndim == 0:
        g, base = g.reshape(1), base.reshape(1)
    rows = max(1, ERR_CHUNK // max(1, g[0].numel()))
    per_row = g[0].numel()
    diff = ref = 0.0
    moved, moves = [], []
    for i in range(0, g.shape[0], rows):
        n = min(rows, g.shape[0] - i)
        b = _block_rows(base, slices, i, n, g.device)
        d = (g[i:i + n].double() - b).reshape(-1)
        diff += float(d.square().sum())
        ref += float(b.square().sum())
        # a move past float32's resolution of the parameter (a few ulps)
        floor = torch.clamp(b.abs().reshape(-1) * ULPS, min=MOVED * lr)
        hit = (d.abs() > floor).nonzero().reshape(-1)
        if hit.numel():
            moved.append(hit.cpu() + i * per_row)
            moves.append(d[hit].abs().cpu())
    rel = (0.0 if diff == 0.0 else math.inf) if ref == 0.0 else \
        math.sqrt(diff / ref)
    if not moved:
        return rel, rel, known, 0, 0.0
    moved, moves = torch.cat(moved), torch.cat(moves)
    new = moved[~torch.isin(moved, known)]
    if new.numel():
        at = list(torch.unravel_index(new, tuple(g.shape)))
        for d, s, _ in slices:
            at[d] = at[d] + s
        known = torch.cat([known, new[scale(tuple(at)) <= dm / MOVED]])
    ok = torch.isin(moved, known)
    rest = diff - float(moves[ok].square().sum())
    rest = (0.0 if rest <= 0.0 else math.inf) if ref == 0.0 else \
        math.sqrt(max(rest, 0.0) / ref)
    return (rel, rest, known, int((~ok).sum()),
            float(moves[ok].max()) / lr_total if ok.any() else 0.0)


def _counters():
    from repro_torch.kernels.delta_decode import ops as dd
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.fused import ops
    from repro_torch.kernels.jagged import ops as jg

    return {"fused_densify": ops.fused_densify,
            "embedding_bag": eb.embedding_bag,
            "jagged_to_padded": jg.jagged_to_padded,
            "delta_decode": dd.delta_decode}


def feed_batches(feed, cell, mesh, n: int, device) -> list:
    """``n`` batches of DLRM-UIH's ``open_feed`` (``feed`` = (sim config,
    days to run, DatasetSpec)) over a sim built from the config, placed
    with ``cell``'s placements on ``mesh`` (``None``: the plain feed), as
    the cell's model inputs."""
    from repro_torch.core.simulation import ProductionSim
    from repro_torch.data import open_feed
    from repro_torch.models import recsys as R

    sim_cfg, days, spec = feed
    sim = ProductionSim(sim_cfg)
    sim.run_days(days, capture_reference=False)
    placement = {} if mesh is None else {"cell": cell, "mesh": mesh}
    f = open_feed(spec, sim, device=device, **placement)
    try:
        out = []
        for b in f:
            out.append(R.dlrm_uih_prep(b, cell.meta["cfg"]))
            if len(out) == n:
                break
    finally:
        f.close(timeout=60.0)
    if len(out) != n:
        raise RuntimeError(f"the feed gave {len(out)} batches, not {n}")
    return out


# ---------------------------------------------------------------------------
# the rank side: a session kept on the rank's mesh between ``run`` calls
# ---------------------------------------------------------------------------

SESSION = "_train_session"     # the key of a rank's session on its mesh


def _lap(session, what: str) -> None:
    if session["cuda"]:
        torch.cuda.synchronize()
    now = time.perf_counter()
    session["laps"][what] = (session["laps"].get(what, 0.0) + now
                             - session["clock"])
    session["clock"] = now


def rank_start(rank: int, mesh, arch: str, shape: str,
               reduced: Dict[str, Any], params, batch, n_steps: int,
               deterministic: bool = False, feed: Optional[tuple] = None,
               smoke: bool = False) -> Dict[str, Any]:
    """Build the cell on this rank's mesh, cut this rank's blocks of the
    shared ``params`` and ``batch`` (or open ``feed`` placed: ``batch``
    then ``None``) and zero moments of its block shapes, and keep them on
    the mesh for ``rank_step``. Returns each leaf's block slices
    (``block_slices``) of the parameters and of the first moments."""
    from repro_torch.train.optimizer import AdamWState

    device = tree_leaves(params)[0].device
    session = {"cuda": device.type == "cuda", "laps": {},
               "clock": time.perf_counter(), "counters": _counters(),
               "deterministic": deterministic}
    for c in session["counters"].values():
        c.launches = 0
    with precision(deterministic):
        cell = build_train_cell(arch, shape, reduced, mesh, smoke)
        pspec, ospec, bsh = cell.in_shardings
        local = tree_map(lambda p, sp: SH.local_block(p.detach(), sp, mesh)
                         .clone(), params, pspec, is_leaf=SH.is_spec)
        zeros = lambda sp, p: torch.zeros(         # noqa: E731
            SH.local_shape(tuple(p.shape), sp, mesh), dtype=torch.float32,
            device=device)
        state = AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_map(zeros, ospec.m, params, is_leaf=SH.is_spec),
            v=tree_map(zeros, ospec.v, params, is_leaf=SH.is_spec))
        shapes = [tuple(p.shape) for p in tree_leaves(params)]
        slices = {
            "params": [block_slices(sh, sp, mesh) for sh, sp in zip(
                shapes, tree_leaves(pspec, is_leaf=SH.is_spec))],
            "m": [block_slices(sh, sp, mesh) for sh, sp in zip(
                shapes, tree_leaves(ospec.m, is_leaf=SH.is_spec))]}
        del params
        if feed is not None:
            batches = feed_batches(feed, cell, mesh, n_steps, device)
        else:
            mine = tree_map(lambda x, sp: SH.local_block(x, sp, mesh)
                            .clone(), batch, bsh, is_leaf=SH.is_spec)
            batches = [mine] * n_steps
        del batch
    session.update(cell=cell, local=local, state=state, batches=batches)
    mesh.__dict__[SESSION] = session
    _lap(session, "blocks")
    if session["cuda"]:
        torch.cuda.reset_peak_memory_stats()
    return slices


def rank_step(rank: int, mesh) -> Dict[str, Any]:
    """The session's next AdamW step: the global loss, gradient norm and
    lr, its ms (CUDA events, a rank process's time) and this rank's live
    parameter and moment blocks, which go to the caller as they are
    (a CUDA tensor as an IPC handle; the caller is done with them before
    the next step writes them)."""
    s = mesh.__dict__[SESSION]
    batch = s["batches"].pop(0)
    with precision(s["deterministic"]):
        if s["cuda"]:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        s["local"], s["state"], metrics = s["cell"].step_fn(
            s["local"], s["state"], batch)
        if s["cuda"]:
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1)
        else:
            ms = (time.perf_counter() - t0) * 1e3
    _lap(s, "steps")
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "lr": float(metrics["lr"]), "ms": ms,
            "params": [t.detach() for t in tree_leaves(s["local"])],
            "m": [t.detach() for t in tree_leaves(s["state"].m)],
            "v": [t.detach() for t in tree_leaves(s["state"].v)]}


def rank_finish(rank: int, mesh) -> Dict[str, Any]:
    """Drop the session and hand the card back: this rank's peak since
    its blocks were cut, the kernels' launches and its host seconds."""
    s = mesh.__dict__.pop(SESSION)
    peak = torch.cuda.max_memory_allocated() if s["cuda"] else 0
    out = {"peak": peak, "seconds": s["laps"],
           "launches": {k: c.launches for k, c in s["counters"].items()}}
    del s
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _adam_scale(outs, slices, j: int, bc2: float, eps: float):
    """``index -> sqrt(v) + eps`` of leaf ``j`` at global ``index`` (a
    tuple of index tensors), read from whichever rank's second-moment
    block holds each element (``outs``: the ranks' ``rank_step``)."""
    def scale(index):
        out = torch.full((len(index[0]),), math.inf, dtype=torch.float64)
        for o, sl in zip(outs, slices):
            v = o["v"][j].reshape(-1) if o["v"][j].ndim == 0 else o["v"][j]
            inside = torch.ones(len(index[0]), dtype=torch.bool)
            local = list(index)
            for d, s, n in sl["m"][j]:
                inside &= (index[d] >= s) & (index[d] < s + n)
                local[d] = index[d] - s
            if inside.any():
                at = tuple(x[inside].to(v.device) for x in local)
                out[inside] = v[at].double().cpu()
        return out.div(bc2).sqrt() + eps

    return scale


def train_on_mesh(pm, arch: str, shape: str, reduced: Dict[str, Any],
                  inputs: list, ref: List[Dict[str, Any]],
                  deterministic: bool = False, feed: Optional[tuple] = None,
                  smoke: bool = False) -> List[Dict[str, Any]]:
    """The cell's steps on the ranks of ``pm`` (a ``ProcessMesh``), one a
    reference step, each rank's blocks held here against the reference's
    (``reference_steps``). ``inputs`` is ``[params, batch]`` (``batch``
    ``None`` with ``feed``): the list is emptied and the tensors dropped
    once every rank has cut its blocks, so a caller that keeps no other
    reference frees them before the ranks step. Returns for each rank
    {"steps": [{"loss",
    "grad_norm", "ms", "params", "params_rest", "explained", "m"} a step:
    {leaf: relative Frobenius error} of its parameter blocks, of them
    without the elements ``param_err`` explains, and of its first-moment
    blocks; {leaf: (explained elements, moved elements not explained,
    largest explained move / summed lr)} where any moved], "peak": bytes,
    "seconds": {part: host seconds}, "launches": {kernel: count}}."""
    from repro_torch.train.optimizer import AdamWConfig

    opt = AdamWConfig()              # the train cells' optimizer
    params, batch = inputs
    inputs.clear()
    slices = pm.run(rank_start, arch, shape, reduced, params, batch,
                    len(ref), deterministic, feed, smoke)
    names = leaf_names(params)
    cuda = tree_leaves(params)[0].is_cuda
    del params, batch
    if cuda:                 # the ranks hold their blocks: free ours
        gc.collect()
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
    known = [{n: torch.zeros(0, dtype=torch.int64) for n in names}
             for _ in slices]
    steps: List[list] = [[] for _ in slices]
    lr_total = 0.0
    for want in ref:
        outs = pm.run(rank_step)
        lr_total += outs[0]["lr"]
        w_p = tree_leaves(want["params"])
        w_m = tree_leaves(want["m"])
        k = len(steps[0]) + 1
        bc1, bc2 = 1 - opt.beta1 ** k, 1 - opt.beta2 ** k
        m_errs = [[rel_err(out["m"][j], w_m[j], sl["m"][j])
                   for j in range(len(names))]
                  for out, sl in zip(outs, slices)]
        for r, (out, sl) in enumerate(zip(outs, slices)):
            errs = {"params": {}, "params_rest": {}, "explained": {},
                    "m": {}}
            for j, n in enumerate(names):
                errs["m"][n] = m_errs[r][j][0]
                # the leaf's largest first-moment difference, any rank's
                dm = max(e[j][1] for e in m_errs) / bc1
                rel, rest, known[r][n], bad, far = param_err(
                    out["params"][j], w_p[j], sl["params"][j],
                    _adam_scale(outs, slices, j, bc2, opt.eps), dm,
                    out["lr"], lr_total, known[r][n])
                errs["params"][n], errs["params_rest"][n] = rel, rest
                if known[r][n].numel() or bad:
                    errs["explained"][n] = (int(known[r][n].numel()), bad,
                                            far)
            steps[r].append({"loss": out["loss"],
                             "grad_norm": out["grad_norm"], "ms": out["ms"],
                             **errs})
        del outs          # the ranks' blocks: released before they step on
        gc.collect()
    return [{"steps": st, **fin}
            for st, fin in zip(steps, pm.run(rank_finish))]


def collectives_on_rank(rank: int, mesh) -> Dict[str, float]:
    """Each collective the train cells call, through
    ``_functional_collectives`` on the mesh's device, over ``data``,
    ``model`` and both axes, against the value this rank computes alone
    from every rank's input: {"<axes>/<collective>": max abs error}."""
    device = torch.device(mesh.device_type,
                          torch.cuda.current_device()
                          if mesh.device_type == "cuda" else None)
    out = {}
    for axes in (("data",), ("model",), ("data", "model")):
        group = axes_group(mesh, axes)
        n, me = axes_size(mesh, axes), axes_rank(mesh, axes)

        def x_of(r):
            """Rank ``r``'s (2n, 3) input over ``axes``."""
            return (torch.arange(6 * n, dtype=torch.float32, device=device)
                    .reshape(2 * n, 3) * (r + 1) + r)

        xs = [x_of(r) for r in range(n)]
        total = sum(xs)
        want = {
            "all_reduce": total,
            "all_gather_tensor": torch.cat(xs, 0),
            "reduce_scatter_tensor": total[2 * me:2 * me + 2],
            "all_to_all_single": torch.cat([x[2 * me:2 * me + 2]
                                            for x in xs], 0),
        }
        got = {
            "all_reduce": funcol.all_reduce(xs[me], "sum", group),
            "all_gather_tensor": funcol.all_gather_tensor(xs[me], 0, group),
            "reduce_scatter_tensor": funcol.reduce_scatter_tensor(
                xs[me], "sum", 0, group),
            "all_to_all_single": funcol.all_to_all_single(
                xs[me], None, None, group),
        }
        for k, g in got.items():
            if isinstance(g, funcol.AsyncCollectiveTensor):
                g = g.wait()
            if g.device != device:
                raise RuntimeError(f"{k} over {axes} returned a tensor on "
                                   f"{g.device}, not {device}")
            out[f"{'+'.join(axes)}/{k}"] = float(
                (g - want[k]).abs().max())
    return out


def whoami(rank: int, mesh, *args) -> tuple:
    """(rank, this process's id, the mesh's coordinates, args): a probe of
    which process answered."""
    import os

    return (rank, os.getpid(), mesh.get_local_rank("data"),
            mesh.get_local_rank("model"), args)


def fail_on(rank: int, mesh, which: int) -> int:
    """Rank ``which`` raises; the others answer."""
    if rank == which:
        raise ValueError(f"rank {rank} raises, as asked")
    return rank


def sleep_on(rank: int, mesh, which: int, seconds: float) -> int:
    """Rank ``which`` sleeps ``seconds`` before it answers."""
    if rank == which:
        time.sleep(seconds)
    return rank


def lower_priority(rank: int, mesh, niceness: int) -> int:
    """This rank's process at ``niceness`` (a test's rank processes below
    the test workers beside them)."""
    import os

    return os.nice(niceness)
