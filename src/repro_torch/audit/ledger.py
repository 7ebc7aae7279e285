"""Append-only, hash-chained audit ledger (DESIGN.md §14).

Every record carries the ``sha`` of its predecessor (``prev_sha``), so the
file is a hash chain rooted at :data:`GENESIS_SHA`. :meth:`AuditLedger.verify`
re-reads the *raw disk bytes* and recomputes the chain; any mutation flips a
record sha, and any insertion, deletion-in-the-middle, or reordering breaks a
``prev_sha`` link. The one attack verify() alone cannot see is **truncation**
— a chopped file is a valid shorter chain — which is why the
``AuditCompleteness`` sim checker cross-checks record counts against the
processing journal and event log (every acked delivery must still have its
provenance record).

Durability is tiered (see :data:`~repro_torch.audit.records.DURABLE_KINDS`):
disclosure-accounting facts (delivery, provenance, policy edits, ingest
applies) are fsynced at append; high-rate per-instance records (lake hits,
detector decisions) ride the OS buffer and become durable at the next
durable append / :meth:`AuditLedger.flush` / :meth:`AuditLedger.close`.
A crash therefore loses at most a tail of non-durable records; replay repairs
a torn tail exactly like the journal (shared ``repro_torch.utils.wal`` helper).

:data:`NULL_LEDGER` is the zero-overhead null object (the ``NULL_TRACER``
pattern): every emit site calls it unconditionally, and the fleet sim proves
a NULL_LEDGER run is bit-identical (event-log digest, metrics, trace digest)
to no ledger at all.
"""
from __future__ import annotations

import hashlib
import os
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, List, Optional

from repro_torch.utils.wal import replay_jsonl

from repro_torch.audit.records import (
    DURABLE_KINDS,
    RECORD_KINDS,
    STRUCTURAL_KEYS,
    canonical_json,
    record_sha,
)

GENESIS_SHA = hashlib.sha256(b"audit|genesis").hexdigest()


class AuditLedger:
    """Hash-chained append-only JSONL ledger of PHI-touching actions."""

    enabled = True

    def __init__(self, path: str | os.PathLike, clock=None) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.clock = clock
        self.torn_tail = 0
        self.corrupt_lines = 0
        self._records: List[dict] = []
        self._head = GENESIS_SHA
        self._dirty = False
        self._batch_depth = 0
        self._pending_sync = False
        self.syncs = 0  # fsync count — the unit auditbench prices
        if self.path.exists():
            replay = replay_jsonl(self.path)
            self.torn_tail += replay.torn_tail
            self.corrupt_lines += replay.corrupt_lines
            # Trust-on-load: replay adopts the recovered chain as-is; verify()
            # is the integrity check, replay is the availability path.
            for rec in replay.records:
                self._records.append(rec)
                self._head = rec.get("sha", self._head)
        self._fh = open(self.path, "a", encoding="utf-8")

    # ----------------------------------------------------------------- write
    def append(self, kind: str, **fields) -> dict:
        """Append one typed record, chained to the current head."""
        if kind not in RECORD_KINDS:
            raise ValueError(f"unknown audit record kind: {kind!r}")
        clash = STRUCTURAL_KEYS.intersection(fields)
        if clash:
            raise ValueError(f"payload collides with structural keys: {sorted(clash)}")
        rec = {
            "kind": kind,
            "seq": len(self._records) + 1,
            "t": float(self.clock.now()) if self.clock is not None else 0.0,
            "prev_sha": self._head,
            **fields,
        }
        rec["sha"] = record_sha(rec)
        self._records.append(rec)
        self._head = rec["sha"]
        # Write the canonical form so a disk re-parse recomputes identically.
        self._fh.write(canonical_json(rec) + "\n")
        if kind in DURABLE_KINDS:
            if self._batch_depth:
                # group commit: the enclosing batch() fsyncs once at exit
                self._dirty = self._pending_sync = True
            else:
                self._sync()
        else:
            self._dirty = True
        return rec

    def _sync(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._dirty = self._pending_sync = False
        self.syncs += 1

    @contextmanager
    def batch(self) -> Iterator["AuditLedger"]:
        """Group-commit scope: durable appends inside the ``with`` defer
        their fsync to ONE sync at exit. Emit sites that write several
        adjacent durable records (the worker's delivery+provenance pair, a
        cohort admission's warm hits) pay one fsync for the group; a crash
        inside the batch loses a suffix of the batch, never an interior
        record — the chain stays a valid prefix either way."""
        self._batch_depth += 1
        try:
            yield self
        finally:
            self._batch_depth -= 1
            if self._batch_depth == 0 and self._pending_sync:
                self._sync()

    def flush(self) -> None:
        if self._dirty and not self._fh.closed:
            self._sync()

    def close(self) -> None:
        self.flush()
        self._fh.close()

    # ------------------------------------------------------------------ read
    def records(self, kind: Optional[str] = None) -> List[dict]:
        if kind is None:
            return list(self._records)
        return [r for r in self._records if r.get("kind") == kind]

    def kind_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self._records:
            k = r.get("kind", "?")
            out[k] = out.get(k, 0) + 1
        return out

    def head(self) -> str:
        return self._head

    def __len__(self) -> int:
        return len(self._records)

    def digest(self) -> str:
        """Commits to both chain head and length — two same-seed sim runs
        must produce bit-identical digests (the determinism contract)."""
        return hashlib.sha256(f"audit|{len(self._records)}|{self._head}".encode()).hexdigest()

    # ---------------------------------------------------------------- verify
    def verify(self) -> List[str]:
        """Recompute the hash chain from the raw disk bytes.

        Returns a list of human-readable problems; ``[]`` means the on-disk
        ledger is an intact chain that matches the in-memory head. Detects
        any mutation (sha mismatch), insertion/deletion/reordering (prev_sha
        or seq break). Truncation alone yields a valid shorter chain — the
        head comparison catches it while this process is alive, and the
        journal cross-checks in ``AuditCompleteness`` bound it after a crash.
        """
        import json

        self.flush()
        problems: List[str] = []
        try:
            with open(self.path, "rb") as fh:
                raw = fh.read()
        except FileNotFoundError:
            return [f"ledger file missing: {self.path}"]
        prev = GENESIS_SHA
        n = 0
        for i, line in enumerate(raw.split(b"\n"), start=1):
            stripped = line.strip()
            if not stripped:
                continue
            try:
                rec = json.loads(stripped)
                if not isinstance(rec, dict):
                    raise ValueError("not a record")
            except ValueError:
                problems.append(f"line {i}: unparseable record")
                prev = None  # chain is broken from here on
                continue
            n += 1
            if rec.get("kind") not in RECORD_KINDS:
                problems.append(f"line {i}: unknown kind {rec.get('kind')!r}")
            if rec.get("seq") != n:
                problems.append(f"line {i}: seq {rec.get('seq')} != expected {n}")
            if prev is not None and rec.get("prev_sha") != prev:
                problems.append(f"line {i}: prev_sha break (chain reordered or edited)")
            want = record_sha(rec)
            if rec.get("sha") != want:
                problems.append(f"line {i}: sha mismatch (record mutated)")
                prev = rec.get("sha")  # follow the claimed chain to localize damage
            else:
                prev = rec["sha"]
        if prev is not None and prev != self._head:
            problems.append(
                f"disk head {str(prev)[:12]} != live head {self._head[:12]} "
                "(file truncated or diverged from this process)"
            )
        return problems


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
        # same value an empty AuditLedger reports
        return hashlib.sha256(f"audit|0|{GENESIS_SHA}".encode()).hexdigest()

    def verify(self) -> List[str]:
        return []


NULL_LEDGER = NullLedger()
