"""Storage tier: mutable + immutable UIH stores, trait-aware columnar codec,
offloaded compaction, symmetric sharding, warehouse/stream ingestion."""
