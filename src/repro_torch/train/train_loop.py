"""End-to-end trainer: data plane feed -> train step -> checkpoints.

Port of ``repro.train.train_loop``. A step splits the batch into
``grad_accum`` microbatches (consecutive row blocks, as the reference's
reshape does) and runs one ``backward()`` per microbatch: gradients sum in
the float32 ``.grad`` of the float32 parameters, then AdamW takes them times
1/count (in its one pass over them) and updates the parameters in place;
with compression on, the mean is int8-compressed with error feedback first,
as the reference does. The loss is any ``loss_fn(params, batch) -> scalar``.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.kernels.adamw import LeafTable
from repro_torch.obs.spans import PhaseClock
from repro_torch.train.grad_compress import compress_with_feedback, ef_init
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map


_END = object()      # fit's end-of-feed sentinel


@dataclasses.dataclass
class TrainerConfig:
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    grad_accum: int = 1          # microbatch accumulation factor
    compress_grads: bool = False
    log_every: int = 10
    # double-buffered device feed: issue the host->device transfer for batch
    # N+1 while step N computes (0 disables; 2 = classic double buffering).
    # Ignored when ``fit`` is handed an already-wrapped DevicePrefetcher.
    prefetch_depth: int = 0
    # device-side late materialization: when fit auto-wraps the feed in a
    # DevicePrefetcher, attach a DeviceMaterializer so compact jagged
    # payloads densify and delta-decode ON DEVICE. Dense host batches pass
    # through untouched. Requires prefetch_depth > 0.
    device_materialize: bool = False
    # bound ``fit`` by wall clock instead of (or in addition to) max_steps
    max_wall_s: Optional[float] = None
    # unified telemetry: a ``repro_torch.obs.Telemetry`` — each step files
    # the phases ``train.feed_wait`` (in ``fit``), ``train.grads``,
    # ``train.optimizer`` and ``train.readback`` under its step number (with
    # their device ms on CUDA), ``fit`` observes a per-step
    # ``repro_train_step_seconds`` histogram from them, ``save``/
    # ``try_resume`` emit checkpoint_save / checkpoint_resume events. Falls
    # back to the feed's own telemetry when None.
    telemetry: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)


class Trainer:
    def __init__(
        self,
        loss_fn: Callable[[Any, Dict[str, Any]], torch.Tensor],
        params: Any,
        cfg: TrainerConfig,
    ):
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.opt_state = adamw_init(params)
        self.opt_table = LeafTable()    # AdamW's leaf table for opt_state
        self.ef_state = ef_init(params) if cfg.compress_grads else None
        self.step = 0
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
                     if cfg.ckpt_dir else None)
        self.history = []
        # set by fit(): the active Feed whose cursor rides along with model
        # checkpoints (feed_state sidecar, exactly-once resume). While a feed
        # is active, run_step defers its periodic autosave to fit — the save
        # must happen AFTER record_train_step so the feed's trained-row
        # counter includes the step being checkpointed.
        self._fit_feed = None
        self._phases = self._phase_clock(cfg.telemetry)
        self._step_s = 0.0   # the last step's seconds, from its phases

    def _phase_clock(self, tel) -> Optional[PhaseClock]:
        """The trainer thread's phase clock over ``tel`` (None: off), with
        CUDA timing events on the card."""
        if tel is None:
            return None
        event = (functools.partial(torch.cuda.Event, enable_timing=True)
                 if self.device.type == "cuda" else None)
        return PhaseClock(tel.spans, event)

    # -- one optimizer step (with optional microbatch accumulation) -----------
    def _grads(self, batch: Dict[str, torch.Tensor]):
        """Mean loss and the float32 gradients summed over the microbatches
        (``adamw_update`` takes the 1/n, inside its one pass over them)."""
        n = self.cfg.grad_accum
        leaves = tree_leaves(self.params)
        for p in leaves:
            p.grad = None
        lsum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(n):
            mb = {}
            for k, v in batch.items():
                b = v.shape[0]
                if b % n:
                    raise ValueError(f"batch {b} not divisible by accum {n}")
                mb[k] = v[i * (b // n):(i + 1) * (b // n)]
            loss = self.loss_fn(self.params, mb)
            loss.backward()
            lsum += loss.detach().float()

        def summed_grad(p):
            if p.grad is None:     # a leaf the loss does not reach
                return torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
            g = p.grad.float()
            p.grad = None
            return g

        return lsum / n, tree_map(summed_grad, self.params)

    def run_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """batch rows are split into ``grad_accum`` microbatches."""
        ph = self._phases
        if ph is not None:
            if not ph.open:          # not inside fit's cycle
                ph.start()
            ph.mark()
        loss, grads = self._grads(batch)
        if ph is not None:
            ph.mark("grads")
            ph.lap("train.grads")
        n = self.cfg.grad_accum
        grad_scale = 1.0 / n
        if self.ef_state is not None:
            # the reference compresses the mean gradient
            for g in tree_leaves(grads):
                g.div_(n)
            grads, self.ef_state = compress_with_feedback(grads, self.ef_state)
            grad_scale = 1.0
        self.params, self.opt_state, stats = adamw_update(
            self.params, grads, self.opt_state, self.cfg.opt,
            grad_scale=grad_scale, table=self.opt_table)
        del grads
        if ph is not None:
            ph.mark("optimizer")
            ph.lap("train.optimizer")
        stats["loss"] = loss
        self.step += 1
        out = {k: float(v) for k, v in stats.items()}
        if ph is not None:
            ph.mark("readback")
            ph.lap("train.readback")
            spans = ph.commit(self.step)
            self._step_s = (spans[-1].t1_ns - spans[-3].t0_ns) / 1e9
        self.history.append(out)
        if (self.ckpt and self.step % self.cfg.ckpt_every == 0
                and self._fit_feed is None):
            self.save()
        return out

    # -- checkpointing ----------------------------------------------------------
    def _state(self) -> Dict[str, Any]:
        state = {"params": self.params, "opt": self.opt_state}
        if self.ef_state is not None:
            state["ef"] = self.ef_state
        return state

    def save(self) -> None:
        if self.ckpt is None:
            raise RuntimeError("save() needs TrainerConfig.ckpt_dir")
        feed_state = None
        feed = self._fit_feed
        if feed is not None and getattr(feed, "can_checkpoint", False):
            feed_state = feed.checkpoint()
        self.ckpt.save(self.step, self._state(), extra={"step": self.step},
                       feed_state=feed_state)
        tel = self._telemetry()
        if tel is not None:
            tel.events.emit("checkpoint_save", step=self.step,
                            has_feed_state=feed_state is not None)

    def try_resume(self) -> bool:
        """Restore the latest checkpoint into the live parameters and
        optimizer state (in place). False when there is none."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        live = self._state()
        state, step, _ = self.ckpt.restore(live)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(live), tree_leaves(state)):
                dst.copy_(src)
        self.step = step
        tel = self._telemetry()
        if tel is not None:
            tel.events.emit("checkpoint_resume", step=step)
        return True

    def _telemetry(self):
        """The active telemetry: the config's, else the fit feed's."""
        if self.cfg.telemetry is not None:
            return self.cfg.telemetry
        return getattr(self._fit_feed, "telemetry", None)

    # -- full loop ---------------------------------------------------------------
    def fit(self, batches: Iterable[Dict[str, Any]],
            max_steps: Optional[int] = None) -> None:
        from repro_torch.data.feed import Feed
        from repro_torch.dpp.prefetch import DevicePrefetcher

        feed = batches
        if (self.cfg.prefetch_depth > 0
                and not isinstance(feed, (DevicePrefetcher, Feed))):
            materialize = None
            if self.cfg.device_materialize:
                from repro_torch.dpp.device_mat import DeviceMaterializer
                materialize = DeviceMaterializer(device=self.device)
            feed = DevicePrefetcher(feed, depth=self.cfg.prefetch_depth,
                                    device=self.device,
                                    materialize=materialize)
        # GPU-busy accounting feeds the elastic controller's starvation signal
        record = getattr(feed, "record_train_step", None)
        self._fit_feed = feed if isinstance(feed, Feed) else None
        tel = self._telemetry()
        step_hist = (tel.registry.histogram(
            "repro_train_step_seconds",
            help="device train-step wall time") if tel is not None else None)
        own_phases = self._phases
        ph = self._phases = (own_phases if tel is self.cfg.telemetry
                             else self._phase_clock(tel))
        t0 = time.perf_counter()

        def batches():
            """Feed iterator honoring ``max_wall_s`` even while BLOCKED on an
            idle-but-open stream: with a timeout-capable getter, poll with a
            bounded wait so the wall budget can fire between batches; the
            feed's ``ended`` flag distinguishes end-of-stream from a timeout."""
            wall = self.cfg.max_wall_s
            get = getattr(feed, "get", None) or getattr(feed, "get_full_batch",
                                                        None)
            if wall is None or get is None:
                yield from feed
                return
            # the live mutable ClientStats: a Feed exposes it as
            # ``client_stats``; legacy feeds expose the object as ``stats``
            stats = getattr(feed, "client_stats", None)
            if stats is None:
                stats = getattr(feed, "stats", None)
                if callable(stats):
                    stats = None
            pending_wait = 0.0   # timed-out poll waits, unrecorded by the feed
            while True:
                remaining = wall - (time.perf_counter() - t0)
                if remaining <= 0:
                    return
                t_poll = time.perf_counter()
                b = get(timeout=min(0.25, max(remaining, 0.01)))
                if b is None:
                    if getattr(feed, "ended", False):
                        return
                    pending_wait += time.perf_counter() - t_poll
                    continue   # timed out; re-check the wall budget
                if pending_wait > 0.0 and stats is not None:
                    # the feed only records waits ending in a delivered batch;
                    # fold the preceding timed-out polls back into starvation
                    # (host-attributed: that is the scale-the-workers signal)
                    stats.starved_time_s += pending_wait
                    stats.starved_host_s += pending_wait
                pending_wait = 0.0
                yield b

        try:
            it = batches()
            while True:
                if ph is not None:
                    ph.start()
                batch = next(it, _END)
                if batch is _END:
                    break
                if ph is not None:
                    ph.lap("train.feed_wait")
                ts = time.perf_counter()
                stats = self.run_step(batch)   # float() of the loss syncs
                dt_step = time.perf_counter() - ts
                if record is not None:
                    record(dt_step)
                if step_hist is not None:
                    step_hist.observe(self._step_s)
                if (self.ckpt and self._fit_feed is not None
                        and self.step % self.cfg.ckpt_every == 0):
                    # deferred from run_step: the feed's trained-row counter
                    # advanced in record() above, so the feed_state sidecar
                    # now names exactly this step's training frontier
                    self.save()
                if self.step % self.cfg.log_every == 0:
                    dt = time.perf_counter() - t0
                    print(f"step {self.step:5d} loss={stats['loss']:.4f} "
                          f"gnorm={stats['grad_norm']:.3f} ({dt:.1f}s)",
                          flush=True)
                if max_steps and self.step >= max_steps:
                    break
                if (self.cfg.max_wall_s is not None
                        and time.perf_counter() - t0 >= self.cfg.max_wall_s):
                    break
        finally:
            self._fit_feed = None
            self._phases = own_phases
            if ph is not None:
                ph.open = False
            # break AND exception paths: release the transfer thread and any
            # queued device batches (idempotent; harmless on exhaustion).
            # A Feed's stop() releases ONLY its device-prefetch stage — the
            # host pipeline stays up for the caller to close()/drain.
            if isinstance(feed, (DevicePrefetcher, Feed)):
                feed.stop()
