"""Durable, crash-replayable pooler checkpoint (DESIGN.md §10).

Journal-style append log (JSONL, fsync per record) shared by the two halves
of the ingest process:

* ``seen`` records — the :class:`~repro_torch.ingest.pooler.ChangePooler` appends
  one *after* publishing a feed event into the broker. The resume cursor
  (:meth:`Checkpoint.floor`) is the largest contiguous seen seq, so a crash
  between publish and ``seen`` re-polls and re-publishes the event — that is
  the at-least-once half of the contract.
* ``op`` records — the :class:`~repro_torch.ingest.pooler.IngestApplier` appends
  one *before* acking a delivery, with the terminal outcome (``applied`` /
  ``dup`` / ``stale``). Redelivery of an already-outcome'd seq is acked
  without effect — that is the effect-idempotent half.

Replay tolerates a torn tail write (crash mid-append): every fully-written
record is recovered and the partial fragment is truncated away, same contract
as ``repro_torch.queueing.journal``.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Set

from repro_torch.utils.wal import append_jsonl, replay_jsonl


class Checkpoint:
    def __init__(self, path: str | os.PathLike) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.seen: Set[int] = set()
        self.outcomes: Dict[int, dict] = {}          # seq -> op record
        self.outcome_log: List[dict] = []            # op records, append order
        self.applied_etag: Dict[str, str] = {}       # accession -> last applied etag
        self.applied_seq: Dict[str, int] = {}        # accession -> max applied seq
        self.double_applied: List[int] = []          # seqs with >1 op record
        self.torn_tail = 0
        self.corrupt_lines = 0  # malformed non-final lines skipped at replay
        self._floor = 0
        if self.path.exists():
            self._replay()
        self._fh = open(self.path, "a", encoding="utf-8")

    # -------------------------------------------------------------- replay
    def _absorb(self, rec: dict) -> None:
        kind = rec.get("kind")
        if kind == "seen" and "seq" in rec:
            self.seen.add(int(rec["seq"]))
        elif kind == "op" and "seq" in rec:
            seq = int(rec["seq"])
            if seq in self.outcomes:
                # must never happen live (the applier checks before writing);
                # recorded so the monotonicity checker can prove it didn't
                self.double_applied.append(seq)
            self.outcomes[seq] = rec
            self.outcome_log.append(rec)
            if rec.get("outcome") == "applied":
                acc = rec.get("accession", "")
                if rec.get("op") == "delete":
                    self.applied_etag.pop(acc, None)
                else:
                    self.applied_etag[acc] = rec.get("etag", "")
                self.applied_seq[acc] = max(self.applied_seq.get(acc, 0), seq)

    def _replay(self) -> None:
        # Torn-tail repair + corrupt-line tolerance via the shared WAL helper.
        replay = replay_jsonl(self.path)
        self.torn_tail += replay.torn_tail
        self.corrupt_lines += replay.corrupt_lines
        for rec in replay.records:
            self._absorb(rec)
        self._refloor()

    def _refloor(self) -> None:
        while (self._floor + 1) in self.seen:
            self._floor += 1

    # ----------------------------------------------------------------- api
    def floor(self) -> int:
        """Largest N such that every seq in 1..N has been seen — the poll
        resume cursor. Seqs above the floor that were individually seen are
        deduped in memory, never lost."""
        return self._floor

    def _append(self, rec: dict) -> None:
        append_jsonl(self._fh, rec)

    def mark_seen(self, seq: int) -> None:
        if seq in self.seen:
            return
        self.seen.add(seq)
        self._refloor()
        self._append({"kind": "seen", "seq": seq})

    def mark_outcome(
        self,
        seq: int,
        accession: str,
        etag: str,
        op: str,
        outcome: str,
        rows: int = 0,
    ) -> None:
        """Record the terminal outcome for one feed seq. ``rows`` is the
        catalog delta this apply produced (the no-full-reingest counter)."""
        rec = {
            "kind": "op",
            "seq": seq,
            "accession": accession,
            "etag": etag,
            "op": op,
            "outcome": outcome,
            "rows": rows,
        }
        self._absorb(rec)
        self._append(rec)

    def has_outcome(self, seq: int) -> bool:
        return seq in self.outcomes

    def close(self) -> None:
        self._fh.close()
