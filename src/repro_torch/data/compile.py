"""``open_feed``: compile a declarative ``DatasetSpec`` into the data plane.

Port of ``repro.data.compile``, batch sources only:

  batch spec --> work items (warehouse buckets | affinity-planned sim epochs)
             --> DPPWorkerPool(WorkerPlan) --> RebatchingClient
  --> optional DevicePrefetcher stage (+ DeviceMaterializer running the
      fused CUDA kernel when ``device_materialize`` is set)
  --> Feed  (one protocol, consumed identically by the Trainer)

Not yet ported: ``StreamSource`` specs (the streaming slice) and
``cell``/``mesh`` sharded device batches (the multi-GPU slice); both raise
``NotImplementedError``.

The ``sim`` argument is the data-platform handle: a ``ProductionSim`` or any
object exposing ``schema``, ``immutable`` (the store), plus ``warehouse`` /
``examples`` for the matching source kinds.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from repro_torch.core.backoff import Backoff
from repro_torch.core.materialize import Materializer
from repro_torch.data.feed import Feed
from repro_torch.data.spec import (
    DatasetSpec,
    SimSource,
    StreamSource,
    WarehouseSource,
    resume_fingerprint,
)
from repro_torch.dpp.affinity import plan_affine
from repro_torch.dpp.client import RebatchingClient
from repro_torch.dpp.elastic import DPPWorkerPool
from repro_torch.dpp.worker import WorkerPlan


def compile_worker_plan(spec: DatasetSpec, sim: Any) -> WorkerPlan:
    """The per-worker slice of a spec: projection + features + a thread-local
    materializer factory carrying the spec's consistency/generation policy."""
    schema = sim.schema
    store = sim.immutable
    features = spec.resolve_features(schema)

    def make_materializer() -> Materializer:
        return Materializer(
            store, schema,
            validate_checksum=spec.validate_checksum,
            pin_generations=spec.pin_generations,
            window_cache_size=spec.window_cache_size,
        )

    return WorkerPlan(projection=spec.tenant, feature_spec=features,
                      schema=schema, make_materializer=make_materializer)


def _retry_backoff(spec: DatasetSpec) -> Optional[Backoff]:
    """Seeded deterministic backoff between a work item's crash-recovery
    retries (the same shared helper the store failover executor uses): short
    enough not to stall a healthy pool, long enough that the second retry of
    a node-outage item usually lands after the flap, and a pure function of
    the spec seed so chaos runs stay reproducible."""
    if spec.max_item_retries <= 0:
        return None
    return Backoff(base_s=0.005, multiplier=2.0, max_s=0.1, jitter=0.5,
                   seed=spec.reshuffle_seed or 0)


def _batch_items(spec: DatasetSpec, sim: Any) -> List[list]:
    """The batch work list a spec describes (each item = one worker unit)."""
    src = spec.source
    bb = spec.base_batch_size
    if isinstance(src, WarehouseSource):
        hours = (list(src.hours) if src.hours is not None
                 else sim.warehouse.hours())
        items: List[list] = []
        for _ in range(src.epochs):
            for hour in hours:
                # buckets ARE the affinity plan: user-clustered at ingestion,
                # bucket key == storage shard key (§4.2.3)
                for bucket in sim.warehouse.iter_bucketed(hour):
                    for lo in range(0, len(bucket), bb):
                        items.append(bucket[lo:lo + bb])
        return items
    assert isinstance(src, SimSource)
    examples = list(sim.examples)
    if not examples:
        return []
    n_shards = sim.immutable.n_shards
    # honor the live generation's placement map (heavy-tail overrides): with a
    # sharded store, work items then stay NODE-local, not just shard-local
    placement = sim.immutable.live_placement()
    rng = np.random.default_rng(spec.reshuffle_seed or 0)
    items = []
    rows, epoch_i = 0, 0
    while True:
        epoch = ([examples[i] for i in rng.permutation(len(examples))]
                 if src.shuffle else list(examples))
        items.extend(plan_affine(epoch, n_shards, bb, placement=placement).items)
        rows += len(epoch)
        epoch_i += 1
        if src.min_rows is not None:
            if rows >= src.min_rows:
                break
        elif epoch_i >= src.epochs:
            break
    return items


def _skip_rows(items: List[list], n: int) -> List[list]:
    """Drop the first ``n`` example rows of a work-item list (crash resume):
    whole items that fall inside the trained prefix disappear, the boundary
    item is trimmed. Row ORDER is untouched, so an ordered feed over the
    result continues the uninterrupted run's batch sequence exactly."""
    if n <= 0:
        return items
    out: List[list] = []
    remaining = n
    for item in items:
        if remaining <= 0:
            out.append(item)
        elif len(item) <= remaining:
            remaining -= len(item)
        else:
            out.append(item[remaining:])
            remaining = 0
    return out


def _warehouse_hour_rows(spec: DatasetSpec, sim: Any) -> List[tuple]:
    """(hour, rows) pairs in replay order (epochs repeated) — the metadata
    behind the checkpoint's observability cursor (hour + intra-hour offset)."""
    src = spec.source
    hours = (list(src.hours) if src.hours is not None
             else sim.warehouse.hours())
    per_hour = [(h, sim.warehouse.hour_rows(h)) for h in hours]
    return per_hour * src.epochs


def _check_resume(spec: DatasetSpec, resume_from: dict) -> tuple:
    """Validate a checkpoint against the spec; returns (rows, batches)."""
    fp = resume_fingerprint(spec)
    got = resume_from.get("fingerprint")
    if got is not None and got != fp:
        raise ValueError(
            "resume_from was checkpointed by a different DatasetSpec "
            f"(fingerprint mismatch):\n  checkpoint: {got}\n  spec:       {fp}")
    want_kind = "stream" if isinstance(spec.source, StreamSource) else "batch"
    kind = resume_from.get("kind", want_kind)
    if kind != want_kind:
        raise ValueError(
            f"resume_from is a {kind!r} checkpoint but the spec compiles a "
            f"{want_kind!r} feed")
    if not spec.ordered:
        raise ValueError("resume requires DatasetSpec.ordered=True "
                         "(deterministic in-order placement)")
    return (int(resume_from.get("trained_rows", 0)),
            int(resume_from.get("trained_batches", 0)))


def open_feed(
    spec: DatasetSpec,
    sim: Any,
    *,
    device: Any = "cuda",
    cell: Any = None,
    mesh: Any = None,
    prep_fn=None,
    controller: Any = None,
    resume_from: Optional[dict] = None,
) -> Feed:
    """Compile ``spec`` against ``sim``'s data platform and start the feed.

    * ``device`` — where the device-prefetch stage puts batches (``"cuda"``
      unless the caller asks for ``"cpu"``);
    * ``cell``/``mesh`` — sharded device batches; not ported yet (raises);
    * ``prep_fn`` — model-specific host transform; runs inside the prefetch
      thread when there is one, else on the consumer's ``get``. A
      ``prep_fn`` expects dense host batches, so it turns device
      materialization off (as in the reference): run model prep on the
      device, inside the loss, to keep the fused kernel on the path;
    * ``controller`` — optional ``ElasticController`` for live pool resizing;
    * ``resume_from`` — a ``Feed.checkpoint()`` dict: the compiled feed
      produces exactly the examples the killed run had NOT yet trained.

    Returns a started ``Feed``. The caller owns shutdown: ``close()`` (or
    iterate to exhaustion + ``join()``).
    """
    if cell is not None or mesh is not None:
        raise NotImplementedError(
            "cell/mesh-sharded device batches come with the multi-GPU slice")
    if isinstance(spec.source, StreamSource):
        raise NotImplementedError(
            "StreamSource feeds come with the port's streaming slice")
    plan = compile_worker_plan(spec, sim)
    tel = spec.telemetry
    if tel is not None:
        # attach to the store tier FIRST (generation flips / lease events /
        # breaker listeners / RTT histogram re-home)
        sim.immutable.telemetry = tel
    # prefetch_depth=None means auto (no device stage without a cell); an
    # explicit depth > 0 adds the device-prefetch stage
    depth = spec.prefetch_depth or 0
    base_rows, base_batches = (
        _check_resume(spec, resume_from) if resume_from else (0, 0))

    # device-side late materialization: only when a device-prefetch stage
    # exists to run the fused kernel and no prep_fn expects dense host
    # batches — otherwise densify on the host (DESIGN §3 rules)
    dev_mat = bool(spec.device_materialize) and depth > 0 and prep_fn is None
    client = RebatchingClient(spec.batch_size,
                              buffer_batches=spec.buffer_batches,
                              shuffle_seed=spec.reshuffle_seed,
                              emit_seq_start=base_batches,
                              emit_jagged=dev_mat)
    # BEFORE the pool starts: the Feed's resume cursor reads every emitted
    # batch's row count from this FIFO (prep_fn may reshape batches)
    client.track_emitted_rows = spec.ordered
    client.telemetry = tel
    pool = DPPWorkerPool.from_plan(plan, client, n_workers=spec.n_workers,
                                   controller=controller,
                                   ordered=spec.ordered,
                                   max_item_retries=spec.max_item_retries,
                                   retry_backoff=_retry_backoff(spec))
    if tel is not None:
        pool.telemetry = tel           # before start(): items mint spans
    pool.start(_skip_rows(_batch_items(spec, sim), base_rows))
    prefetcher = None
    inner = client
    if depth > 0:
        from repro_torch.dpp.prefetch import DevicePrefetcher

        materialize = None
        if dev_mat:
            from repro_torch.dpp.device_mat import DeviceMaterializer

            materialize = DeviceMaterializer(device=device)
        prefetcher = DevicePrefetcher(client, depth=depth, device=device,
                                      prep_fn=prep_fn,
                                      materialize=materialize)
        if tel is not None:
            prefetcher.telemetry = tel
        inner = prefetcher
    resume_meta = None
    if spec.ordered:
        resume_meta = {"fingerprint": resume_fingerprint(spec),
                       "base_rows": base_rows,
                       "base_batches": base_batches}
        if isinstance(spec.source, WarehouseSource):
            resume_meta["hour_rows"] = _warehouse_hour_rows(spec, sim)
    return Feed(inner, client=client, pool=pool, prefetcher=prefetcher,
                prep_fn=prep_fn, spec=spec, resume_meta=resume_meta,
                telemetry=tel, store=sim.immutable)
