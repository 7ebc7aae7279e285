"""Shared write-ahead-log (JSONL) replay + repair.

Three subsystems keep crash-durable state as append-only JSONL files —
the processing journal (``repro_torch.queueing.journal``), the ingest checkpoint
(``repro_torch.ingest.checkpoint``), and the audit ledger (``repro_torch.audit.ledger``).
All three need the same replay semantics:

* a **torn tail** (crash mid-append left a partial final line) must be
  *repaired* — truncated away — not merely skipped, because appending after
  a partial line would concatenate the next record onto the garbage and
  corrupt both;
* a complete final record that is merely missing its trailing newline is
  absorbed and the newline finished, so future appends stay line-aligned;
* a malformed line that is NOT the tail was fully written and then damaged —
  it is tolerated (skipped) but surfaced via a counter so invariant checkers
  can prove nothing was silently dropped.

:func:`replay_jsonl` implements that contract once; the callers keep their
own ``_absorb`` logic and counter surfaces.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import IO, List


@dataclass
class WalReplay:
    """Result of replaying (and repairing) one JSONL WAL file."""

    records: List[dict] = field(default_factory=list)
    torn_tail: int = 0      # truncated partial final records (repaired in place)
    corrupt_lines: int = 0  # malformed non-final lines skipped


def _parse(line: bytes) -> dict:
    rec = json.loads(line)
    if not isinstance(rec, dict):
        raise ValueError("not a record")
    return rec


def replay_jsonl(path: str | os.PathLike) -> WalReplay:
    """Replay ``path``, repairing a torn tail in place.

    Returns every fully-written dict record in file order. A missing file
    yields an empty replay (no repair performed).
    """
    out = WalReplay()
    p = Path(path)
    if not p.exists():
        return out
    with open(p, "rb") as fh:
        raw = fh.read()
    body, sep, tail = raw.rpartition(b"\n")
    for line in body.split(b"\n") if sep else []:
        stripped = line.strip()
        if not stripped:
            continue
        try:
            out.records.append(_parse(stripped))
        except ValueError:
            out.corrupt_lines += 1
    if tail.strip():
        try:
            rec = _parse(tail)
        except ValueError:
            # torn tail: the crash interrupted the final append. Recover
            # every fully-written record and truncate the fragment away.
            out.torn_tail += 1
            with open(p, "r+b") as fh:
                fh.truncate(len(raw) - len(tail))
        else:
            # complete record, missing only its newline: finish the line
            out.records.append(rec)
            with open(p, "ab") as fh:
                fh.write(b"\n")
    return out


def append_jsonl(fh: IO[str], rec: dict, fsync: bool = True) -> None:
    """Append one record as a JSON line. ``fsync=True`` makes it durable
    before returning (the journal/checkpoint default); ``fsync=False``
    leaves it in the OS buffer for a later explicit flush (the audit
    ledger's non-durable record kinds)."""
    fh.write(json.dumps(rec) + "\n")
    if fsync:
        fh.flush()
        os.fsync(fh.fileno())
