"""Elastic DPP scaling + straggler mitigation (paper §4.2.1; fault tolerance).

The controller watches job-level GPU-starvation % (trainer idle) and worker
waste % (CPU idle) and adjusts the provisioned worker count so training stays
compute-bound. ``DPPWorkerPool`` runs N featurizing workers over planned work
items straight into the trainer's slot-based rebatching client, resizing live
on the controller's decisions. ``StragglerAwarePool`` re-dispatches work items
whose worker exceeded the straggler deadline (speculative execution), and
survives worker crashes.

**Self-healing** (``max_item_retries > 0``): a worker that dies mid-item —
store IOError, decode corruption, a crash injected by the fault harness
(``repro.testing``) — requeues its work item at the FRONT of the dispatch
order with a per-item attempt count, and a replacement worker (fresh state,
fresh caches) is spawned before the dying thread exits. Materialization is a
pure read, so re-running an item is safe; the item never reached the client
(failures inside ``put`` are NOT healed — a partially placed base batch
poisons its slot and retrying would duplicate rows), so slot accounting stays
exact and the output is byte-identical to a fault-free run. An item that
exhausts its retries is handed to ``on_abandon`` (streaming drop semantics:
release its generation leases) when set, else its error is fatal — batch
training must never silently drop examples. Surfaced via ``WorkerStats``:
``worker_restarts``, ``items_requeued``, ``lease_recoveries``.

**Ordered placement** (``ordered=True``): workers still materialize+featurize
concurrently, but finished base batches pass through a reorder buffer and a
single placer thread that copies them into the rebatching client in work-item
sequence order. Emitted full batches then compose deterministically from the
item list regardless of worker count, scheduling, crashes, or retries — the
property both the chaos tests ("byte-identical to the fault-free run") and
``Feed.checkpoint`` exactly-once resume (rows consumed = a prefix of the
canonical example order) are built on. Admission control bounds how far ahead
of the placement cursor a worker may start (``4 × workers``), so a slow head
item cannot buffer the whole epoch in RAM.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, Deque, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.backoff import Backoff
from repro_torch.obs.clock import now_ns


@dataclasses.dataclass
class ElasticConfig:
    min_workers: int = 1
    max_workers: int = 32
    target_starvation_pct: float = 2.0   # scale up above this
    target_waste_pct: float = 60.0       # scale down above this
    step: int = 1


class ElasticController:
    """Pure decision logic (separated from the pool so it is unit-testable)."""

    def __init__(self, cfg: ElasticConfig):
        self.cfg = cfg
        self.decisions: List[int] = []

    def decide(self, workers: int, starvation_pct: float, waste_pct: float) -> int:
        new = workers
        if starvation_pct > self.cfg.target_starvation_pct:
            new = min(self.cfg.max_workers, workers + self.cfg.step)
        elif waste_pct > self.cfg.target_waste_pct and starvation_pct == 0.0:
            new = max(self.cfg.min_workers, workers - self.cfg.step)
        self.decisions.append(new)
        return new


@dataclasses.dataclass
class PoolStats:
    completed: int = 0
    speculative_retries: int = 0
    worker_failures: int = 0


class DPPWorkerPool:
    """N DPP workers draining planned work items into a rebatching client.

    Each thread owns a private ``DPPWorker`` (materializers are not shared
    across threads — their window caches and IO accounting are thread-local by
    design), pulls work items (example lists, e.g. ``plan_affine(...).items``)
    from a shared queue, and ``put``s the featurized base batch into the slot
    buffer of the trainer's ``RebatchingClient``.

    Elasticity: a monitor thread periodically feeds the job-level signals —
    trainer ``starvation_pct`` from the client, mean worker ``waste_pct`` —
    to an ``ElasticController`` and applies its decision: growth starts new
    worker threads immediately; shrink is cooperative (threads with index
    beyond the target retire before their next pull). Worker exceptions are
    captured and re-raised from ``join``/``run`` — never swallowed.
    """

    def __init__(
        self,
        worker_factory: Callable[[], "object"],
        client,
        n_workers: int = 2,
        controller: Optional[ElasticController] = None,
        control_interval_s: float = 0.25,
        close_client: bool = True,
        jagged: bool = True,
        max_item_retries: int = 0,
        ordered: bool = False,
        on_place: Optional[Callable[[List], None]] = None,
        on_abandon: Optional[Callable[[List, BaseException], None]] = None,
        on_skip: Optional[Callable[[List], None]] = None,
        retry_backoff: Optional["Backoff"] = None,
    ):
        self.worker_factory = worker_factory
        self.client = client
        self.controller = controller
        self.control_interval_s = control_interval_s
        self.close_client = close_client
        # fused path: workers emit arena+offsets base batches and the client
        # scatters them straight into slots (falls back to the dense put when
        # either side predates the jagged API)
        self.jagged = (jagged and hasattr(client, "put_jagged"))
        self._items: "queue.Queue" = queue.Queue()
        self._n_initial = n_workers
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._workers: List[object] = []
        self._errors: List[BaseException] = []
        self._live = 0      # threads spawned and not yet exited
        self._retire = 0    # pending cooperative-shrink tokens
        self._done = threading.Event()
        # set once no further items will arrive: immediately by ``start``
        # (static work list), by the feeder thread's exit for ``start_stream``
        self._feed_done = threading.Event()
        self._feeder: Optional[threading.Thread] = None
        self._monitor: Optional[threading.Thread] = None
        self.items_done = 0
        self.peak_workers = n_workers
        # -- self-healing (see class docstring) -------------------------------
        self.max_item_retries = max_item_retries
        self.on_abandon = on_abandon
        # seeded deterministic backoff between an item's retries (shared
        # helper with the store failover path): the delay is a pure function
        # of (seed, attempt, item seq), so chaos runs stay reproducible.
        # None = immediate requeue (the historical behavior).
        self.retry_backoff = retry_backoff
        self._seq = 0                       # next work-item sequence number
        # retried tasks go to the FRONT of the dispatch order (ahead of the
        # shared queue): with one worker this restores exact item order, with
        # N it minimizes reorder-buffer stall after a crash
        self._retry: Deque[Tuple[int, int, List]] = collections.deque()
        # seq -> monotonic not-before time: the backoff delay of a requeued
        # item, paid by the worker that CLAIMS the retry (the retry itself is
        # visible in ``_retry`` immediately — an invisible in-flight retry
        # could wedge ordered admission: every worker blocks in ``_admit`` on
        # seqs past the crashed hole while nobody holds the hole's retry)
        self._retry_ready: Dict[int, float] = {}
        self.worker_restarts = 0
        self.items_requeued = 0
        self.items_abandoned = 0
        self.lease_recoveries = 0   # via record_lease_recoveries (lock-guarded)
        # -- ordered placement -------------------------------------------------
        self.ordered = ordered
        self.on_place = on_place
        # called (in placement order) for an item that reached its placement
        # turn WITHOUT output — abandoned after retries. Consumers tracking
        # stream positions (the session's resume cursor) must see skips too.
        self.on_skip = on_skip
        self._place_cv = threading.Condition()
        # seq -> (put_fn, out, item); (None, None, None) = tombstone
        self._obuf: Dict[int, Tuple] = {}
        self._next_place = 0
        self._obuf_cap = max(8, 4 * n_workers)
        self._place_dead = False
        self._placer: Optional[threading.Thread] = None
        # optional per-run telemetry (repro.obs.Telemetry): span mint point
        # for the whole pipeline — the work-item seq IS the correlation id
        self.telemetry = None

    @classmethod
    def from_plan(cls, plan, client, **kwargs) -> "DPPWorkerPool":
        """Pool over a spec-compiled ``repro.dpp.worker.WorkerPlan`` instead
        of a hand-wired worker factory (the declarative read path's entry)."""
        from repro_torch.dpp.worker import DPPWorker

        return cls(lambda: DPPWorker.from_plan(plan), client, **kwargs)

    # -- worker loop -------------------------------------------------------------
    def _task(self, item: List) -> Tuple[int, int, List]:
        with self._lock:
            seq = self._seq
            self._seq += 1
        tel = self.telemetry
        if tel is not None:
            tel.spans.mint(seq)   # sampled 1-in-N inside the tracker
        return (seq, 0, item)

    def _worker_loop(self, worker) -> None:
        t0 = time.perf_counter()
        if self.telemetry is not None:
            worker.telemetry = self.telemetry   # CPU time and dpp.* phases
        try:
            while True:
                with self._lock:
                    if self._retire > 0:
                        self._retire -= 1
                        return  # cooperative shrink: retire this thread
                    task = self._retry.popleft() if self._retry else None
                    not_before = (self._retry_ready.pop(task[0], 0.0)
                                  if task is not None else 0.0)
                if task is not None and not_before:
                    # claimed retry still inside its backoff window: THIS
                    # thread owns it now (it counts in ``_live``, so the pool
                    # cannot drain out underneath), so just wait it out
                    remaining = not_before - time.monotonic()
                    if remaining > 0:
                        time.sleep(remaining)
                if task is None:
                    try:
                        task = self._items.get(timeout=0.05)
                    except queue.Empty:
                        if self._feed_done.is_set() and self._items.empty():
                            with self._lock:
                                if not self._retry:
                                    return  # stream over AND queues drained
                        continue    # live feed: stay parked for the next item
                seq, attempts, item = task
                if self.ordered and not self._admit(seq):
                    # placement is wedged (placer died): hand the task back so
                    # any surviving sibling can observe it, and bail out
                    with self._lock:
                        self._retry.append(task)
                    return
                tel = self.telemetry
                if tel is not None:
                    # park this item's span in the thread-local so the
                    # worker's _lookup/_featurize record stages ambiently
                    tel.spans.enter_item(seq)
                try:
                    if self.jagged and hasattr(worker, "process_jagged"):
                        out = worker.process_jagged(item)
                        put = self.client.put_jagged
                    else:
                        out = worker.process(item)
                        put = self.client.put
                except BaseException as exc:
                    # the item never reached the client: requeue-and-respawn is
                    # safe (materialization is a pure read). Failures inside
                    # ``put`` below are NOT healed — a partial placement
                    # poisons its slot, so a retry would duplicate rows.
                    if tel is not None:
                        tel.events.emit("worker_crash", seq=seq,
                                        error=type(exc).__name__)
                    if self._heal(seq, attempts, item, exc):
                        return  # replacement spawned; this thread retires
                    if tel is not None:
                        tel.spans.abandon(seq)
                    self._tombstone(seq)
                    raise
                finally:
                    if tel is not None:
                        tel.spans.exit_item()
                self._deliver(seq, item, out, put)
                with self._lock:
                    self.items_done += 1
        except BaseException as e:
            with self._lock:
                self._errors.append(e)
        finally:
            with self._lock:
                self._live -= 1
            if self.ordered:
                with self._place_cv:
                    self._place_cv.notify_all()  # placer re-checks liveness
            worker.stats.total_time_s += time.perf_counter() - t0

    # -- self-healing ------------------------------------------------------------
    def _heal(self, seq: int, attempts: int, item: List,
              exc: BaseException) -> bool:
        """Recover from a worker dying mid-item. Returns True when handled
        (item requeued or abandoned, replacement spawned); False means the
        failure is fatal and the caller must record it."""
        if self.max_item_retries <= 0:
            return False
        attempts += 1
        if attempts > self.max_item_retries:
            if self.on_abandon is None:
                # batch training: silently dropping examples is worse than
                # dying — surface the poison item's error from join()
                return False
            with self._lock:
                self.items_abandoned += 1
            try:
                self.on_abandon(item, exc)
            except BaseException as cb_exc:
                with self._lock:
                    self._errors.append(cb_exc)
            if self.telemetry is not None:
                self.telemetry.spans.abandon(seq)
                self.telemetry.events.emit("item_abandoned", seq=seq,
                                           attempts=attempts)
            self._tombstone(seq, item)
        else:
            with self._lock:
                if self.retry_backoff is not None:
                    # seeded deterministic delay between this item's retries;
                    # stamped as a not-before time and paid by the worker
                    # that claims the retry (see ``_retry_ready``)
                    self._retry_ready[seq] = time.monotonic() + \
                        self.retry_backoff.delay(attempts - 1, token=seq)
                self._retry.append((seq, attempts, item))
                self.items_requeued += 1
            if self.telemetry is not None:
                self.telemetry.events.emit("item_requeued", seq=seq,
                                           attempts=attempts)
        self._respawn()
        return True

    def record_lease_recoveries(self, n: int) -> None:
        """Count leases released through crash recovery (the session's
        ``on_abandon`` calls this; every pool counter mutates under the
        lock so concurrent abandons cannot lose updates)."""
        with self._lock:
            self.lease_recoveries += n

    def _respawn(self) -> None:
        """Replace a dying worker with a fresh one (fresh materializer, fresh
        caches) BEFORE the dying thread exits, so the logical worker count —
        and the guarantee that a requeued head item finds a runnable thread —
        never dips."""
        if self.telemetry is not None:
            self.telemetry.events.emit("worker_restart")
        with self._lock:
            self.worker_restarts += 1
            if self._retire > 0:
                self._retire -= 1   # a pending shrink wanted one fewer anyway
                return
            worker = self.worker_factory()
            th = threading.Thread(target=self._worker_loop, args=(worker,),
                                  daemon=True,
                                  name=f"dpp-worker-{len(self._threads)}")
            self._workers.append(worker)
            self._threads.append(th)
            self._live += 1
            th.start()

    # -- ordered placement (reorder buffer -> single placer thread) ---------------
    def _admit(self, seq: int) -> bool:
        """Bound how far ahead of the placement cursor a worker may start: a
        slow/crashed head item must not let the rest of the pool materialize
        the whole epoch into the reorder buffer. The head (and any already
        admitted retry) is always admitted, so recovery cannot deadlock."""
        with self._place_cv:
            while seq >= self._next_place + self._obuf_cap:
                if self._place_dead or self._done.is_set():
                    return False
                self._place_cv.wait(timeout=0.1)
            return not self._place_dead

    def _put_with_span(self, seq: int, put, out) -> None:
        """``put`` with the item's span parked in the thread-local so the
        client can attach it to every slot the rows land in; records the
        place stage and retires the span from the live-item map."""
        tel = self.telemetry
        if tel is None:
            put(out)
            return
        tel.spans.enter_item(seq, attempt=False)
        t0 = now_ns()
        c0 = time.thread_time_ns()
        try:
            put(out)
            cpu = time.thread_time_ns() - c0
            t1 = now_ns()
            tel.spans.phase("dpp.place", threading.current_thread().name, t0,
                            t1, cpu, seq)
            sp = tel.spans.get(seq)
            if sp is not None:
                sp.stage("place", t0 / 1e9, t1 / 1e9)
        finally:
            tel.spans.exit_item()
            tel.spans.finish_item(seq)

    def _finish_span(self, seq: int) -> None:
        """Retire an item that reached its placement turn without a ``put``
        (worker dropped every example) so its span cannot orphan."""
        if self.telemetry is not None:
            self.telemetry.spans.finish_item(seq)

    def _deliver(self, seq: int, item: List, out, put) -> None:
        if not self.ordered:
            if self.on_place is not None:
                self.on_place(item)     # before put, as in the placer
            if out is not None:   # None = worker dropped every example
                self._put_with_span(seq, put, out)
            else:
                self._finish_span(seq)
            return
        with self._place_cv:
            self._obuf[seq] = (put, out, item)
            self._place_cv.notify_all()

    def _tombstone(self, seq: int, item: Optional[List] = None) -> None:
        """Mark a seq that will never produce output (abandoned item or fatal
        failure) so ordered placement can advance past it. An abandoned item
        rides along so ``on_skip`` can observe it at its placement turn."""
        if not self.ordered:
            return
        with self._place_cv:
            self._obuf[seq] = (None, None, item)
            self._place_cv.notify_all()

    def _placer_loop(self) -> None:
        try:
            while True:
                with self._place_cv:
                    while self._next_place not in self._obuf:
                        if self._placer_done():
                            return
                        self._place_cv.wait(timeout=0.05)
                    seq = self._next_place
                    put, out, item = self._obuf.pop(seq)
                # place OUTSIDE the cv: ``put`` may block on the client's
                # bounded slot queue (that stall IS the pool's backpressure —
                # admission gates on the cursor, which only moves below).
                # on_place runs BEFORE put: the session's resume ledger must
                # cover a row before the batch containing it can possibly be
                # delivered/trained/checkpointed (ledger-ahead is harmless,
                # ledger-behind would crash a racing checkpoint())
                if put is not None:
                    if item is not None and self.on_place is not None:
                        self.on_place(item)
                    if out is not None:
                        self._put_with_span(seq, put, out)
                    else:
                        self._finish_span(seq)
                elif item is not None and self.on_skip is not None:
                    self.on_skip(item)   # abandoned item reached its turn
                with self._place_cv:
                    self._next_place += 1
                    self._place_cv.notify_all()
        except BaseException as e:
            with self._lock:
                self._errors.append(e)
            with self._place_cv:
                self._place_dead = True      # unwedge admission waiters
                self._place_cv.notify_all()

    def _placer_done(self) -> bool:
        """Call with ``_place_cv`` held and ``_next_place`` not buffered: no
        further deposit can arrive once the feed is finished and no worker is
        alive to produce (or requeue) one."""
        if not self._feed_done.is_set():
            return False
        with self._lock:
            return self._live == 0 and not self._retry

    def _resize_to(self, target: int) -> None:
        """Grow by spawning threads; shrink by issuing retirement tokens."""
        with self._lock:
            logical = self._live - self._retire
            if target > logical:
                for _ in range(target - logical):
                    worker = self.worker_factory()
                    th = threading.Thread(
                        target=self._worker_loop, args=(worker,),
                        daemon=True, name=f"dpp-worker-{len(self._threads)}")
                    self._workers.append(worker)
                    self._threads.append(th)
                    self._live += 1
                    th.start()
            elif target < logical:
                self._retire += logical - target
            self.peak_workers = max(self.peak_workers, target)

    def current_workers(self) -> int:
        with self._lock:
            return max(0, self._live - self._retire)

    # -- elasticity ---------------------------------------------------------------
    def _busy_time_total(self) -> float:
        with self._lock:
            workers = list(self._workers)
        return sum(w.stats.busy_time_s for w in workers)

    def _monitor_loop(self) -> None:
        """Feed WINDOWED starvation/waste to the controller: lifetime
        aggregates ratchet — one slow warmup step (jit compile) would read as
        permanent starvation, growing to max_workers and never shrinking
        (the shrink branch needs a starvation-free WINDOW, which a cumulative
        counter can never show again after its first recorded wait)."""
        last_starved = self.client.stats.starved_time_s
        last_train = self.client.stats.train_time_s
        last_busy = self._busy_time_total()
        last_t = time.perf_counter()
        while not self._done.wait(self.control_interval_s):
            if self._feed_done.is_set() and self._items.empty():
                return
            s = self.client.stats
            now = time.perf_counter()
            d_starved = s.starved_time_s - last_starved
            d_train = s.train_time_s - last_train
            busy = self._busy_time_total()
            d_busy = busy - last_busy
            d_wall = (now - last_t) * max(self.current_workers(), 1)
            last_starved, last_train, last_busy, last_t = (
                s.starved_time_s, s.train_time_s, busy, now)
            denom = d_starved + d_train
            starvation = 100.0 * d_starved / denom if denom > 0 else 0.0
            waste = max(0.0, 1.0 - d_busy / d_wall) * 100.0 if d_wall > 0 \
                else 0.0
            new = self.controller.decide(self.current_workers(), starvation,
                                         waste)
            self._resize_to(new)

    # -- API ---------------------------------------------------------------------
    def start(self, items: Sequence[List]) -> "DPPWorkerPool":
        """Dispatch a STATIC work list; workers exit once it is drained."""
        for item in items:
            self._items.put(self._task(item))
        self._feed_done.set()
        self._start_threads()
        return self

    def start_stream(self, items: Iterable[List],
                     max_buffered: int = 0) -> "DPPWorkerPool":
        """Dispatch a LIVE item source (e.g. ``StreamingSource.micro_batches``):
        a feeder thread pulls items as they become available and workers stay
        parked across idle gaps; they exit only when the source is exhausted
        AND the queue is drained. A feeder failure is re-raised from
        ``join()`` like any worker error.

        ``max_buffered`` > 0 bounds the item queue, applying backpressure to
        the source — without it a fast producer (e.g. a warehouse backfill
        replay) would buffer its entire output in memory ahead of the
        workers."""
        if max_buffered > 0:
            # workers have not started yet; swapping the queue is safe
            self._items = queue.Queue(maxsize=max_buffered)

        def feeder() -> None:
            try:
                for item in items:
                    task = self._task(item)
                    while True:
                        # NO live workers + recorded errors = the pool died:
                        # stop feeding (checked per attempt, not just on
                        # queue.Full, so an unbounded queue doesn't keep
                        # consuming the source for nobody), or join() (and
                        # the client close that unblocks the trainer) would
                        # wait on this feeder forever
                        with self._lock:
                            dead = self._live == 0 and bool(self._errors)
                        if dead:
                            return
                        try:
                            self._items.put(task, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:
                with self._lock:
                    self._errors.append(e)
            finally:
                self._feed_done.set()

        self._feeder = threading.Thread(target=feeder, daemon=True,
                                        name="dpp-feeder")
        self._feeder.start()
        self._start_threads()
        return self

    def _start_threads(self) -> None:
        self._resize_to(self._n_initial)
        if self.ordered and self._placer is None:
            self._placer = threading.Thread(target=self._placer_loop,
                                            daemon=True, name="dpp-placer")
            self._placer.start()
        if self.controller is not None:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True)
            self._monitor.start()

    def _join_workers(self) -> None:
        while True:
            with self._lock:
                alive = [t for t in self._threads if t.is_alive()]
            if not alive:
                return
            for t in alive:
                t.join()

    @property
    def errors(self) -> List[BaseException]:
        with self._lock:
            return list(self._errors)

    def join(self) -> None:
        try:
            # workers first: if they ALL died on errors while the feeder is
            # parked on a full bounded queue, the feeder's dead-pool check
            # needs the worker exits to have landed before it can abort
            self._join_workers()
            if self._feeder is not None:
                while self._feeder.is_alive():
                    self._feeder.join(timeout=0.1)
                    if self._feeder.is_alive():
                        with self._lock:
                            dead = self._live == 0 and bool(self._errors)
                        if dead:
                            # the feeder may be parked INSIDE the source
                            # iterator (idle-open stream) where no dead-pool
                            # check can run: abandon the daemon thread so the
                            # client close + error re-raise below still happen
                            break
            self._join_workers()
            self._done.set()
            if self._monitor is not None:
                self._monitor.join()
            self._join_workers()   # monitor may have spawned a final thread
            if self._placer is not None:
                self._placer.join()
        finally:
            # close EVEN ON worker failure: the consumer must receive the
            # end-of-stream sentinel or it blocks forever on a dead feed
            # (the raise below reaches join's caller, not the trainer)
            if self.close_client:
                self.client.close()
        if self._errors:
            raise RuntimeError(
                f"{len(self._errors)} DPP worker(s) failed") from self._errors[0]

    def run(self, items: Sequence[List]) -> "DPPWorkerPool":
        """Blocking convenience: dispatch ``items``, wait, close the client.

        The client's buffer must be drained concurrently (or sized to hold the
        whole stream) or workers block on the bounded slot queue."""
        self.start(items)
        self.join()
        return self

    def merged_worker_stats(self):
        """Aggregate per-thread WorkerStats into one job-level view."""
        from repro_torch.dpp.worker import WorkerStats

        out = WorkerStats()
        with self._lock:
            workers = list(self._workers)
        for w in workers:
            s = w.stats
            out.base_batches += s.base_batches
            out.examples += s.examples
            out.probe_time_s += s.probe_time_s
            out.lookup_time_s += s.lookup_time_s
            out.featurize_time_s += s.featurize_time_s
            out.total_time_s += s.total_time_s
            out.dedup_hits += s.dedup_hits
            out.decode_cache_hits += s.decode_cache_hits
            out.parallel_shards += s.parallel_shards
            out.cpu_time_s += s.cpu_time_s
        with self._lock:
            out.worker_restarts += self.worker_restarts
            out.items_requeued += self.items_requeued
            out.lease_recoveries += self.lease_recoveries
        return out


class StragglerAwarePool:
    """Thread pool with deadline-based speculative re-dispatch.

    Work items are idempotent (materialization is a pure read), so running a
    straggler's item twice is safe — first completion wins.
    """

    def __init__(
        self,
        work_fn: Callable[[object], object],
        n_workers: int = 2,
        straggler_deadline_s: float = 5.0,
    ):
        self.work_fn = work_fn
        self.straggler_deadline_s = straggler_deadline_s
        self._task_q: "queue.Queue" = queue.Queue()
        self._done: Dict[int, object] = {}
        self._done_cv = threading.Condition()
        self._inflight: Dict[int, float] = {}   # task id -> dispatch time
        self._retried: set = set()
        self._stop = threading.Event()
        self.stats = PoolStats()
        self._threads: List[threading.Thread] = []
        self.resize(n_workers)

    # -- worker loop -------------------------------------------------------------
    def _loop(self, me: int) -> None:
        while not self._stop.is_set():
            try:
                task_id, payload = self._task_q.get(timeout=0.05)
            except queue.Empty:
                continue
            with self._done_cv:
                if task_id in self._done:   # speculative duplicate already done
                    continue
                self._inflight[task_id] = time.perf_counter()
            try:
                result = self.work_fn(payload)
            except Exception:
                self.stats.worker_failures += 1
                # crash-equivalent: re-queue the item for another worker
                self._task_q.put((task_id, payload))
                continue
            with self._done_cv:
                if task_id not in self._done:
                    self._done[task_id] = result
                    self.stats.completed += 1
                self._inflight.pop(task_id, None)
                self._done_cv.notify_all()

    # -- API ---------------------------------------------------------------------
    def submit(self, task_id: int, payload: object) -> None:
        self._task_q.put((task_id, payload))

    def _respeculate(self, pending_payloads: Dict[int, object]) -> None:
        now = time.perf_counter()
        with self._done_cv:
            for tid, started in list(self._inflight.items()):
                if (
                    now - started > self.straggler_deadline_s
                    and tid not in self._retried
                    and tid in pending_payloads
                ):
                    self._retried.add(tid)
                    self.stats.speculative_retries += 1
                    self._task_q.put((tid, pending_payloads[tid]))

    def gather(self, task_ids, payloads: Dict[int, object], timeout_s: float = 60.0):
        """Wait for all task_ids, re-dispatching stragglers as needed."""
        deadline = time.perf_counter() + timeout_s
        while True:
            with self._done_cv:
                if all(t in self._done for t in task_ids):
                    return [self._done[t] for t in task_ids]
                self._done_cv.wait(timeout=0.05)
            self._respeculate(payloads)
            if time.perf_counter() > deadline:
                raise TimeoutError("pool gather timed out")

    def resize(self, n_workers: int) -> None:
        while len(self._threads) < n_workers:
            t = threading.Thread(target=self._loop, args=(len(self._threads),),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        # shrink is cooperative: extra threads exit when stop is set; for the
        # simulation we only record the logical size
        self.n_workers = n_workers

    def shutdown(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
