"""Tamper-evident audit plane: the hash-chained PHI-access ledger and its
record taxonomy. The accounting-of-disclosures report is not ported yet."""
from repro_torch.audit.ledger import GENESIS_SHA, AuditLedger, NULL_LEDGER, NullLedger
from repro_torch.audit.records import (
    DEAD_LETTER,
    DEID_EXECUTE,
    DELIVERY,
    DETECTOR_DECISION,
    DURABLE_KINDS,
    INGEST_APPLY,
    LAKE_EVICT,
    LAKE_HIT,
    LAKE_WRITE,
    POLICY_EDIT,
    PROVENANCE,
    RECORD_KINDS,
    SOURCE_FETCH,
    TELEMETRY_EXPORT,
    canonical_json,
    record_sha,
)

__all__ = [
    "AuditLedger",
    "NullLedger",
    "NULL_LEDGER",
    "GENESIS_SHA",
    "record_sha",
    "canonical_json",
    "RECORD_KINDS",
    "DURABLE_KINDS",
    "SOURCE_FETCH",
    "DEID_EXECUTE",
    "DETECTOR_DECISION",
    "LAKE_WRITE",
    "LAKE_HIT",
    "LAKE_EVICT",
    "DELIVERY",
    "PROVENANCE",
    "DEAD_LETTER",
    "INGEST_APPLY",
    "POLICY_EDIT",
    "TELEMETRY_EXPORT",
]
