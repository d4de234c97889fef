"""Multi-tenant sequence projection (paper §2.3, §4.1.2, §4.2.2).

Each model tenant declares its UIH requirements — target sequence length,
feature groups, and optionally a trait subset per group. The DPP query engine
pushes these down to the immutable store so short-sequence / few-feature
tenants never over-fetch (eliminating the multi-tenant penalty).

Trait ordering is **canonical**: ``timestamp`` first (it is the versioning
key), then the group's schema order, then any non-schema extras in declaration
order, deduped. Overridden and schema-default groups therefore produce
identical orderings for identical trait sets — which is what makes window-
cache keys, union projections, and per-tenant carved views line up
byte-for-byte.

``TenantProjection`` is frozen and hashable (``traits_per_group`` is
normalized to tuples at construction), so it can key caches and live inside a
frozen ``repro.data.DatasetSpec``. ``TenantProjection.union`` builds the
*union* projection serving N tenants from ONE scan (max ``seq_len``, union of
feature groups, per-group union of traits); ``project_view`` carves a single
tenant's view back out of a union-fetched window.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core import events as ev


def canonical_traits(
    schema: ev.TraitSchema, group: str, cols: Sequence[str]
) -> Tuple[str, ...]:
    """Canonicalize a trait list: ``timestamp`` first, then the group's schema
    order, then non-schema extras in declaration order; deduped."""
    requested: List[str] = []
    seen = set()
    for t in cols:
        if t not in seen:
            seen.add(t)
            requested.append(t)
    group_order = schema.group_traits(group)
    in_schema = [t for t in group_order if t in seen and t != "timestamp"]
    extras = [t for t in requested
              if t not in group_order and t != "timestamp"]
    return ("timestamp", *in_schema, *extras)


@dataclasses.dataclass(frozen=True)
class TenantProjection:
    name: str
    seq_len: int                                 # target UIH length (events)
    feature_groups: Tuple[str, ...]              # groups the model consumes
    traits_per_group: Optional[Mapping[str, Tuple[str, ...]]] = None

    def __post_init__(self):
        if self.seq_len <= 0:
            raise ValueError(f"seq_len must be positive, got {self.seq_len}")
        # normalize to immutable forms so the projection is safely hashable
        # (callers may hand in lists / dicts); the read-only proxy keeps a
        # projection already used as a cache/spec key from being mutated out
        # from under its recorded hash
        object.__setattr__(self, "feature_groups", tuple(self.feature_groups))
        if self.traits_per_group is not None:
            object.__setattr__(
                self, "traits_per_group",
                types.MappingProxyType(
                    {g: tuple(cols)
                     for g, cols in self.traits_per_group.items()}))

    # dict fields are unhashable; hash the canonical content fingerprint
    # (dataclass __eq__ still compares fields directly, which is consistent:
    # equal projections have equal fingerprints)
    def __hash__(self) -> int:
        return hash(self.fingerprint())

    def fingerprint(self) -> tuple:
        """Hashable identity of the projection's content (cache keys)."""
        tp = self.traits_per_group
        return (
            self.name,
            self.seq_len,
            self.feature_groups,
            tuple(sorted((g, tuple(c)) for g, c in tp.items())) if tp else None,
        )

    def traits_for(self, schema: ev.TraitSchema, group: str) -> Tuple[str, ...]:
        """The group's traits under this projection, in canonical order.

        Both the override path and the schema-default path go through the same
        canonicalization (timestamp first, then schema order, deduped) — the
        orderings must not depend on WHERE the trait list came from, or
        ``all_traits()`` of two equivalent projections would differ."""
        if self.traits_per_group and group in self.traits_per_group:
            cols = self.traits_per_group[group]
        else:
            cols = schema.group_traits(group)
        return canonical_traits(schema, group, cols)

    def all_traits(self, schema: ev.TraitSchema) -> Tuple[str, ...]:
        seen = []
        for g in self.feature_groups:
            for t in self.traits_for(schema, g):
                if t not in seen:
                    seen.append(t)
        return tuple(seen)

    @classmethod
    def union(
        cls,
        tenants: Sequence["TenantProjection"],
        schema: ev.TraitSchema,
        name: str = "union",
    ) -> "TenantProjection":
        """The union projection serving every tenant from ONE co-scan (§2.3):
        max ``seq_len``, union of feature groups (schema order first, then
        non-schema extras), per-group union of traits in canonical order.

        Each tenant's solo fetch is a *sub-view* of the union fetch:
        ``project_view`` carves it back out byte-identically."""
        tenants = list(tenants)
        if not tenants:
            raise ValueError("union of zero tenants")
        if len(tenants) == 1:
            return tenants[0]
        groups: List[str] = []
        for t in tenants:
            for g in t.feature_groups:
                if g not in groups:
                    groups.append(g)
        schema_order = [g for g in schema.feature_groups if g in groups]
        groups = schema_order + [g for g in groups if g not in schema_order]
        traits: Dict[str, Tuple[str, ...]] = {}
        for g in groups:
            cols: List[str] = []
            for t in tenants:
                if g in t.feature_groups:
                    for c in t.traits_for(schema, g):
                        if c not in cols:
                            cols.append(c)
            traits[g] = canonical_traits(schema, g, cols)
        return cls(
            name=name,
            seq_len=max(t.seq_len for t in tenants),
            feature_groups=tuple(groups),
            traits_per_group=traits,
        )


def project_view(
    window: ev.EventBatch, tenant: TenantProjection, schema: ev.TraitSchema
) -> ev.EventBatch:
    """Carve one tenant's immutable view out of a wider (union-projection)
    window: keep the most recent ``seq_len`` events, project to the tenant's
    traits. Byte-identical to the tenant's own solo store fetch — the union
    window holds the most recent ``max(seq_len)`` events of the SAME bounded
    range, so its tail is exactly the narrower tenant's event set."""
    return ev.tail_view(window, tenant.seq_len, tenant.all_traits(schema))


# The paper's three evaluation tenants (Table 1): long / mid / short sequence.
def table1_tenants(
    long_len: int = 2048, mid_len: int = 512, short_len: int = 64
) -> Dict[str, TenantProjection]:
    return {
        "model_a": TenantProjection(
            name="model_a",  # flagship late-stage ranking: long seq, all groups
            seq_len=long_len,
            feature_groups=("core", "engagement", "sideinfo"),
        ),
        "model_b": TenantProjection(
            name="model_b",  # pre-ranking: mid seq, no sideinfo
            seq_len=mid_len,
            feature_groups=("core", "engagement"),
        ),
        "model_c": TenantProjection(
            name="model_c",  # retrieval: short seq, core ids only
            seq_len=short_len,
            feature_groups=("core",),
            traits_per_group={"core": ("timestamp", "item_id")},
        ),
    }
