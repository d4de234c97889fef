"""Data-affinity planning for batch training (paper §4.2.3).

Two complementary strategies:
  1. user bucketing at warehouse-ingestion time (see ``storage.stream.Warehouse``)
     groups a user's temporally-adjacent examples so one immutable lookup is
     amortized across them (``Materializer.materialize_batch`` exploits it);
  2. symmetric sharding: the warehouse bucket key equals the immutable store's
     partition key, so a bucket's lookups hit exactly one shard (zero fanout).

This module plans DPP work assignments honoring both. With the immutable tier
disaggregated (``storage.sharded_store``), the plan additionally honors the
generation's **placement map**: items are clustered by the (node, shard) the
store will actually route to — including the heavy-tail overrides that move
ultra-long users off their hash node — so every work item's lookups land on
exactly one store NODE (zero cross-node network fanout), not just one logical
shard.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.versioning import TrainingExample
from repro_torch.storage.sharding import PlacementMap, shard_of


@dataclasses.dataclass
class AffinityPlan:
    # work items: each is a list of examples a single DPP worker processes
    items: List[List[TrainingExample]]
    expected_fanout: float            # avg distinct shards per item
    amortizable_pairs: int            # adjacent same-(user,window) example pairs
    expected_node_fanout: float = 1.0  # avg distinct store NODES per item
    # replica-aware affinity tags: per work item, the ORDERED store-node
    # chain that can serve it shard-locally — the primary the item was
    # clustered on first, then the placement's round-robin replicas. A
    # dispatcher can keep an item node-local THROUGH a node outage by
    # falling down the chain instead of scattering the item. [(0,)] per item
    # without a placement map (monolith) or at r=1.
    item_replicas: List[Tuple[int, ...]] = dataclasses.field(
        default_factory=list)


def _tag_of(
    e: TrainingExample, n_shards: int, placement: Optional[PlacementMap]
) -> Tuple[int, int]:
    """(node, shard) routing tag — computed ONCE per example and threaded
    through sort, cut and fanout accounting. Without a placement map the node
    is a constant 0, so the monolith plan (and its item order) is unchanged."""
    shard = shard_of(e.user_id, n_shards)
    node = placement.node_of(e.user_id) if placement is not None else 0
    return (node, shard)


def plan_affine(
    examples: Sequence[TrainingExample],
    n_shards: int,
    base_batch_size: int,
    placement: Optional[PlacementMap] = None,
) -> AffinityPlan:
    """User-clustered plan: sort by (node, shard, user, request_ts,
    request_id) — a TOTAL order, so the plan is invariant under input
    permutation — and cut into base batches at (node, shard) boundaries. All
    lookups in an item target exactly ONE shard on ONE store node (zero
    cross-node fanout, the §4.2.3 symmetric-sharding goal); same-user
    adjacency maximizes window-cache hits."""
    tagged = [(_tag_of(e, n_shards, placement), e) for e in examples]
    tagged.sort(key=lambda te: (te[0], te[1].user_id, te[1].request_ts,
                                te[1].request_id))
    items: List[List[TrainingExample]] = []
    tags: List[List[Tuple[int, int]]] = []
    run: List[TrainingExample] = []
    run_tags: List[Tuple[int, int]] = []
    run_tag = None
    for tag, e in tagged:
        if run and (tag != run_tag or len(run) >= base_batch_size):
            items.append(run)
            tags.append(run_tags)
            run, run_tags = [], []
        run_tag = tag
        run.append(e)
        run_tags.append(tag)
    if run:
        items.append(run)
        tags.append(run_tags)
    return _plan(items, tags, placement)


def plan_arrival_order(
    examples: Sequence[TrainingExample],
    n_shards: int,
    base_batch_size: int,
    placement: Optional[PlacementMap] = None,
) -> AffinityPlan:
    """Baseline plan: arrival order (no clustering) — what a Fat-Row-era
    pipeline does; used as the benchmark control."""
    order = list(examples)
    items = [
        order[i : i + base_batch_size]
        for i in range(0, len(order), base_batch_size)
    ]
    tags = [[_tag_of(e, n_shards, placement) for e in item] for item in items]
    return _plan(items, tags, placement)


def _replica_chain(
    node: int, placement: Optional[PlacementMap]
) -> Tuple[int, ...]:
    """The ordered store-node chain serving a node-affine item: the same
    round-robin anti-affinity rule ``PlacementMap.replicas_of`` uses, so the
    chain names exactly the nodes that hold the item's bytes."""
    if placement is None:
        return (node,)
    r = max(1, min(placement.replication_factor, placement.n_nodes))
    return tuple((node + k) % placement.n_nodes for k in range(r))


def _plan(
    items: List[List[TrainingExample]],
    tags: List[List[Tuple[int, int]]],
    placement: Optional[PlacementMap] = None,
) -> AffinityPlan:
    fanouts = []
    node_fanouts = []
    amortizable = 0
    for item, item_tags in zip(items, tags):
        fanouts.append(len({t[1] for t in item_tags}))
        node_fanouts.append(len({t[0] for t in item_tags}))
        for a, b in zip(item, item[1:]):
            same_window = (
                not a.is_fat
                and not b.is_fat
                and a.user_id == b.user_id
                and a.version is not None
                and b.version is not None
                and (a.version.start_ts, a.version.end_ts)
                == (b.version.start_ts, b.version.end_ts)
            )
            amortizable += int(same_window)
    return AffinityPlan(
        items=items,
        expected_fanout=sum(fanouts) / max(len(fanouts), 1),
        amortizable_pairs=amortizable,
        expected_node_fanout=sum(node_fanouts) / max(len(node_fanouts), 1),
        # the chain keys off the item's clustering tag (arrival-order items
        # mixing nodes use their first example's node: fanout already >1)
        item_replicas=[_replica_chain(item_tags[0][0], placement)
                       for item_tags in tags],
    )
