"""Tamper-evident audit plane: hash-chained PHI-access ledger, per-delivery
provenance, and the accounting-of-disclosures report (DESIGN.md §14)."""
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
from repro_torch.audit.report import DisclosureReport, export_ledger_jsonl

__all__ = [
    "AuditLedger",
    "NullLedger",
    "NULL_LEDGER",
    "GENESIS_SHA",
    "DisclosureReport",
    "export_ledger_jsonl",
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
