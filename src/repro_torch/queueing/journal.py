"""Processing journal: exactly-once effect + checkpoint/restart.

At-least-once delivery (broker) + idempotent completion record (journal) =
exactly-once output, the standard cloud pattern. The journal is an append-only
JSONL file, fsynced per batch, so a killed worker pool resumes from durable
state: completed keys are skipped on redelivery, manifests survive restarts.

This is the de-id plane's checkpoint mechanism (DESIGN.md §5); the training
plane's equivalent lives in `repro_torch.training.checkpoint`.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Iterator, Optional

from repro_torch.core.manifest import Manifest
from repro_torch.utils.wal import append_jsonl, replay_jsonl


class Journal:
    def __init__(self, path: str | os.PathLike) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._completed: Dict[str, dict] = {}
        self.supersessions = 0  # done-records that replaced a stale-etag entry
        self.torn_tail = 0      # truncated final records dropped at replay
        self.corrupt_lines = 0  # malformed non-final lines skipped at replay
        if self.path.exists():
            self._replay()
        self._fh = open(self.path, "a", encoding="utf-8")

    def _absorb(self, rec: dict) -> None:
        if rec.get("kind") != "done" or "key" not in rec:
            return
        prev = self._completed.get(rec["key"])
        if prev is not None and prev.get("source_etag") != rec.get("source_etag"):
            self.supersessions += 1
        self._completed[rec["key"]] = rec

    def _replay(self) -> None:
        # Torn-tail repair + corrupt-line tolerance live in the shared WAL
        # helper (repro_torch.utils.wal); the journal keeps only its absorb logic.
        replay = replay_jsonl(self.path)
        self.torn_tail += replay.torn_tail
        self.corrupt_lines += replay.corrupt_lines
        for rec in replay.records:
            self._absorb(rec)

    # ------------------------------------------------------------------ api
    def is_done(self, key: str) -> bool:
        return key in self._completed

    def record_done(
        self,
        key: str,
        manifest: Manifest,
        worker_id: str,
        source_etag: Optional[str] = None,
    ) -> bool:
        """Record completion. Returns False if key was already done for the
        same source version (the duplicate worker's output is discarded —
        first ack wins). A completion carrying a *different* ``source_etag``
        supersedes the stale record: the source mutated and the key was
        legitimately re-de-identified (incremental re-deid, not a duplicate)."""
        prev = self._completed.get(key)
        if prev is not None:
            if source_etag is None or prev.get("source_etag") == source_etag:
                return False
            self.supersessions += 1
        rec = {
            "kind": "done",
            "key": key,
            "worker": worker_id,
            "source_etag": source_etag,
            "counts": manifest.counts(),
            "manifest": json.loads(manifest.to_json()),
        }
        self._completed[key] = rec
        append_jsonl(self._fh, rec)
        return True

    def etag_for(self, key: str) -> Optional[str]:
        """Source content etag the completion for ``key`` was computed from
        (None for legacy records or unknown keys) — the freshness handle the
        planner and workers compare against the live source."""
        rec = self._completed.get(key)
        return rec.get("source_etag") if rec is not None else None

    def completed_keys(self) -> set:
        return set(self._completed)

    def manifest_for(self, key: str) -> Optional[Manifest]:
        """The completion manifest recorded for ``key``, or None."""
        rec = self._completed.get(key)
        if rec is None:
            return None
        return Manifest.from_json(json.dumps(rec["manifest"]))

    def manifests(self) -> Iterator[Manifest]:
        for rec in self._completed.values():
            yield Manifest.from_json(json.dumps(rec["manifest"]))

    def merged_manifest(self, request_id: str) -> Manifest:
        merged = Manifest(request_id)
        for m in self.manifests():
            merged.merge(m)
        return merged

    def close(self) -> None:
        self._fh.close()
