"""Audit ledger null object.

The hash-chained ledger itself (append-only JSONL, fsync tiers, chain
verification) belongs to the serving layer and is not part of this package
yet. :data:`NULL_LEDGER` is the zero-overhead null object every emit site
calls unconditionally; a caller may hand the pipeline any object with the
same ``append(kind, **fields)`` surface.
"""
from __future__ import annotations

import hashlib
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

GENESIS_SHA = hashlib.sha256(b"audit|genesis").hexdigest()


class NullLedger:
    """No-op ledger: no clock reads, no I/O, no allocation on append."""

    enabled = False
    path = None
    clock = None
    torn_tail = 0
    corrupt_lines = 0

    syncs = 0

    def append(self, kind: str, **fields) -> None:
        return None

    @contextmanager
    def batch(self) -> Iterator["NullLedger"]:
        yield self

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def records(self, kind: Optional[str] = None) -> List[dict]:
        return []

    def kind_counts(self) -> Dict[str, int]:
        return {}

    def head(self) -> str:
        return GENESIS_SHA

    def __len__(self) -> int:
        return 0

    def digest(self) -> str:
        # same value an empty hash-chained ledger reports
        return hashlib.sha256(f"audit|0|{GENESIS_SHA}".encode()).hexdigest()

    def verify(self) -> List[str]:
        return []


NULL_LEDGER = NullLedger()
