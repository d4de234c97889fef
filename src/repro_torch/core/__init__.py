"""Core of the paper's contribution: the versioned late materialization
protocol (events/traits, version metadata, inference-time snapshotting,
training-time time-travel reconstruction, O2O consistency auditing,
multi-tenant projection, and the Fat Row baseline/cost model)."""

from repro_torch.core import events
from repro_torch.core.events import (  # noqa: F401
    EventBatch,
    StreamConfig,
    SyntheticEventStream,
    TraitSchema,
    TraitSpec,
    default_schema,
)
from repro_torch.core.projection import TenantProjection, table1_tenants  # noqa: F401
from repro_torch.core.versioning import TrainingExample, VersionMetadata  # noqa: F401
