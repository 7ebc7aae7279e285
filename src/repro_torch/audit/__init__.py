"""Audit plane: the record taxonomy and the null ledger."""
from repro_torch.audit.ledger import GENESIS_SHA, NULL_LEDGER, NullLedger
from repro_torch.audit.records import DEID_EXECUTE, RECORD_KINDS, canonical_json, record_sha

__all__ = ["GENESIS_SHA", "NULL_LEDGER", "NullLedger", "DEID_EXECUTE", "RECORD_KINDS",
           "canonical_json", "record_sha"]
