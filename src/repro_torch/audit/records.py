"""Audit record taxonomy + canonical hashing (DESIGN.md §14).

Every PHI-touching action in the de-id plane emits one typed record into the
:class:`~repro_torch.audit.ledger.AuditLedger`. The record *kinds* below are the
closed vocabulary; the ledger rejects anything else so a typo can never
silently open an unaccounted category.

Hashing convention: a record's ``sha`` is the SHA-256 of its **canonical
JSON** (floats rounded to 9 places, sorted keys, compact separators — the
same convention the tracer and sim event log use for their digests) computed
over every field *except* ``sha`` itself. The ledger writes the canonical
form to disk, so re-parsing a line and recomputing its sha is bit-stable.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict

# ----------------------------------------------------------------- taxonomy
SOURCE_FETCH = "source_fetch"            # worker read PHI bytes from the source
DEID_EXECUTE = "deid_execute"            # pipeline ran the de-id kernels on a study
DETECTOR_DECISION = "detector_decision"  # burned-in-PHI detector ran on an instance
LAKE_WRITE = "lake_write"                # de-identified bytes written into the lake
LAKE_HIT = "lake_hit"                    # de-identified bytes served out of the lake
LAKE_EVICT = "lake_evict"                # lake entry dropped (lru / invalidate / lost)
DELIVERY = "delivery"                    # a ticket was delivered to its destination
PROVENANCE = "provenance"                # lineage record for one delivery (see ledger doc)
DEAD_LETTER = "dead_letter"              # a ticket exhausted redelivery and was parked
INGEST_APPLY = "ingest_apply"            # a source mutation reached a terminal outcome
POLICY_EDIT = "policy_edit"              # ruleset / detector-policy deploy or edit
TELEMETRY_EXPORT = "telemetry_export"    # spans/metrics left the system boundary

RECORD_KINDS = frozenset(
    {
        SOURCE_FETCH,
        DEID_EXECUTE,
        DETECTOR_DECISION,
        LAKE_WRITE,
        LAKE_HIT,
        LAKE_EVICT,
        DELIVERY,
        PROVENANCE,
        DEAD_LETTER,
        INGEST_APPLY,
        POLICY_EDIT,
        TELEMETRY_EXPORT,
    }
)

# Kinds fsynced at append time. Everything else is python-buffered and made
# durable at the next durable append / explicit flush / close — a crash can
# lose a *tail* of non-durable records (bounded by the journal cross-check in
# the AuditCompleteness checker) but never a delivery/provenance/policy fact.
DURABLE_KINDS = frozenset({DELIVERY, PROVENANCE, POLICY_EDIT, INGEST_APPLY})

# Field names owned by the chain itself; payloads may not collide with them.
STRUCTURAL_KEYS = frozenset({"kind", "seq", "t", "prev_sha", "sha"})


def canonical(obj):
    """Round floats (9 places) so shas survive re-serialization."""
    if isinstance(obj, float):
        return round(obj, 9)
    if isinstance(obj, dict):
        return {k: canonical(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [canonical(v) for v in obj]
    return obj


def canonical_json(obj: Dict[str, object]) -> str:
    return json.dumps(canonical(obj), sort_keys=True, separators=(",", ":"))


def record_sha(rec: Dict[str, object]) -> str:
    """SHA-256 over the canonical JSON of ``rec`` minus its ``sha`` field."""
    body = {k: v for k, v in rec.items() if k != "sha"}
    return hashlib.sha256(canonical_json(body).encode()).hexdigest()
