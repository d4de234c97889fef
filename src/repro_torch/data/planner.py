"""Multi-tenant co-scan planning (paper §2.3, §4.2.2, Table 1).

One normalized immutable UIH tier serves a *union* of heterogeneous model
tenants. Given N ``DatasetSpec``s (or bare ``TenantProjection``s) over the
same store, ``MultiTenantPlanner`` computes the per-window union projection
(max ``seq_len``, union of feature groups / trait columns), issues ONE
planned co-scan through the store's ``plan()``/``execute_plan()`` machinery
(via ``Materializer.materialize_multi``), and carves each tenant's view back
out host-side (tail-slice to its ``seq_len`` + trait projection) —
byte-identical to what that tenant's solo ``materialize_batch`` would have
produced, at a fraction of the read amplification.

``TenantShareStats`` quantifies the win per co-scanned window:
``bytes_saved_vs_solo`` (Σ solo-scan bytes − union-scan bytes) and
``union_overfetch_bytes`` (union bytes beyond the widest single tenant) —
the counters behind Table 1's multi-tenant amplification elimination.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch.core import events as ev
from repro_torch.core.materialize import Materializer, TenantShareStats
from repro_torch.core.projection import TenantProjection
from repro_torch.data.spec import DatasetSpec
from repro_torch.dpp.affinity import AffinityPlan, plan_affine
from repro_torch.storage.protocol import StoreProtocol


class MultiTenantPlanner:
    """Co-scan N tenants' reads over one store.

    ``specs`` may mix ``DatasetSpec``s and bare ``TenantProjection``s; when
    ``DatasetSpec``s are given they must agree on consistency and generation
    policy (one co-scan can only run one policy). Tenant names must be unique
    — they key the per-tenant outputs.
    """

    def __init__(
        self,
        specs: Sequence[Union[DatasetSpec, TenantProjection]],
        store: StoreProtocol,
        schema: ev.TraitSchema,
        *,
        window_cache_size: int = 0,
    ):
        if not specs:
            raise ValueError("MultiTenantPlanner needs at least one spec")
        tenants: List[TenantProjection] = []
        ds = [s for s in specs if isinstance(s, DatasetSpec)]
        for s in specs:
            tenants.append(s.tenant if isinstance(s, DatasetSpec) else s)
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"tenant names must be unique, got {names}")
        if ds:
            pol = {(s.consistency, s.generations) for s in ds}
            if len(pol) != 1:
                raise ValueError(
                    f"co-scanned specs must share consistency/generation "
                    f"policy, got {sorted(pol)}")
        validate = ds[0].validate_checksum if ds else False
        pin = ds[0].pin_generations if ds else False
        self.tenants = tenants
        self.schema = schema
        self.store = store
        self.union = (tenants[0] if len(tenants) == 1
                      else TenantProjection.union(tenants, schema))
        self.materializer = Materializer(
            store, schema, validate_checksum=validate, pin_generations=pin,
            window_cache_size=window_cache_size)
        self.share_stats = TenantShareStats()

    # -- co-scan ---------------------------------------------------------------
    def materialize_batch(
        self, examples: Sequence[Any]
    ) -> Dict[str, List[ev.EventBatch]]:
        """ONE union co-scan for the batch's windows, carved per tenant.

        Returns ``{tenant_name: [per-example EventBatch]}``; each tenant's
        list is byte-identical to its solo ``materialize_batch`` output."""
        return self.materializer.materialize_multi(
            examples, self.tenants, share_stats=self.share_stats,
            union=self.union)

    # -- work planning ---------------------------------------------------------
    def plan_items(
        self, examples: Sequence[Any], base_batch_size: int
    ) -> AffinityPlan:
        """Affinity-plan a co-scanned epoch against THIS planner's store:
        items are clustered by the store's routing — shard on the monolith,
        (node, shard) under the live placement map on the sharded store — so
        every co-scan work item stays node-local (zero cross-node fanout)."""
        return plan_affine(
            examples, self.store.n_shards, base_batch_size,
            placement=self.store.live_placement())

    # -- introspection ---------------------------------------------------------
    @property
    def io_stats(self):
        """This planner's store traffic (the materializer-local accumulator)."""
        return self.materializer.io_stats

    @property
    def stats(self):
        return self.materializer.stats
