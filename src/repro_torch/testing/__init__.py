"""Deterministic fault-injection harness (§10): seeded FaultPlans + wrapper
layers that turn chaos scenarios into reproducible tests."""
from repro_torch.testing.faults import (
    ALL_KINDS,
    CONSUME_KINDS,
    NODE_STATE_KINDS,
    SCAN_KINDS,
    DecodeCorruption,
    FaultPlan,
    FaultSpec,
    FaultyStore,
    FaultyStream,
    FaultySim,
    InjectedFault,
    InjectedIOError,
    WorkerCrash,
    wrap_sim,
)

__all__ = [
    "ALL_KINDS",
    "CONSUME_KINDS",
    "NODE_STATE_KINDS",
    "SCAN_KINDS",
    "DecodeCorruption",
    "FaultPlan",
    "FaultSpec",
    "FaultyStore",
    "FaultyStream",
    "FaultySim",
    "InjectedFault",
    "InjectedIOError",
    "WorkerCrash",
    "wrap_sim",
]
