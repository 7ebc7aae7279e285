"""Deterministic fleet simulator + invariant conformance suite (DESIGN.md §7).

``FleetSim`` drives the real DeidService -> Broker -> WorkerPool -> Autoscaler
-> ResultLake -> StudyStore stack under seeded traffic and chaos schedules;
``repro_torch.sim.invariants`` checks the run end to end. Single-seed
replayability is the contract: same seed, byte-identical event log and
metrics, on the card (the default) and on ``device="cpu"`` alike.
"""
from repro_torch.sim.chaos import ChaosEvent, ChaosSchedule
from repro_torch.sim.events import Event, EventLog, EventQueue, HashRng
from repro_torch.sim.harness import FleetConfig, FleetReport, FleetSim
from repro_torch.sim.invariants import (
    DEFAULT_CHECKERS,
    AuditCompleteness,
    AutoscalerAccounting,
    CheckpointMonotonicity,
    ExactlyOnceDelivery,
    Freshness,
    InvariantChecker,
    JournalDurability,
    LakeConsistency,
    MetricsConservation,
    NoFullReingest,
    NoWedgedSubscribers,
    PhiBoundary,
    QueryConsistency,
    SloConformance,
    TelemetryPhiBoundary,
    TraceIntegrity,
    Violation,
    WarmReplayIdentity,
)
from repro_torch.sim.traffic import (
    BurstyTraffic,
    CohortArrival,
    DiurnalTraffic,
    QueryArrival,
    QueryMix,
    ReplayStorm,
)

__all__ = [
    "AuditCompleteness",
    "AutoscalerAccounting",
    "BurstyTraffic",
    "ChaosEvent",
    "ChaosSchedule",
    "CheckpointMonotonicity",
    "CohortArrival",
    "DEFAULT_CHECKERS",
    "DiurnalTraffic",
    "Event",
    "EventLog",
    "EventQueue",
    "ExactlyOnceDelivery",
    "FleetConfig",
    "FleetReport",
    "FleetSim",
    "Freshness",
    "HashRng",
    "InvariantChecker",
    "JournalDurability",
    "LakeConsistency",
    "MetricsConservation",
    "NoFullReingest",
    "NoWedgedSubscribers",
    "PhiBoundary",
    "QueryArrival",
    "QueryConsistency",
    "QueryMix",
    "ReplayStorm",
    "SloConformance",
    "TelemetryPhiBoundary",
    "TraceIntegrity",
    "Violation",
    "WarmReplayIdentity",
]
