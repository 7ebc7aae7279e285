"""Per-request manifest: "indicates the transformations applied to each image,
along with success or failure states" (paper §Method).

Manifest entries record *actions*, never original PHI values — the manifest
travels with the de-identified output into the researcher's workspace.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple


class Outcome(Enum):
    ANONYMIZED = "anonymized"  # passed filter, metadata anonymized (maybe scrubbed)
    FILTERED = "filtered"      # rejected by filter stage (not delivered)
    FAILED = "failed"          # processing error


@dataclass
class ManifestEntry:
    sop_uid_anon: str
    outcome: Outcome
    modality: str = ""
    filter_rule: Optional[str] = None          # which rule rejected it
    scrub_rects: List[Tuple[int, int, int, int]] = field(default_factory=list)
    tag_actions: Dict[str, str] = field(default_factory=dict)  # keyword -> action
    recompressed: bool = False
    compressed_bytes: int = 0
    original_bytes: int = 0
    error: str = ""
    worker_id: str = ""
    script_shas: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "sop_uid_anon": self.sop_uid_anon,
            "outcome": self.outcome.value,
            "modality": self.modality,
            "filter_rule": self.filter_rule,
            "scrub_rects": [list(r) for r in self.scrub_rects],
            "tag_actions": self.tag_actions,
            "recompressed": self.recompressed,
            "compressed_bytes": self.compressed_bytes,
            "original_bytes": self.original_bytes,
            "error": self.error,
            "worker_id": self.worker_id,
            "script_shas": self.script_shas,
        }
        return d

    @staticmethod
    def from_dict(ed: dict) -> "ManifestEntry":
        return ManifestEntry(
            sop_uid_anon=ed["sop_uid_anon"],
            outcome=Outcome(ed["outcome"]),
            modality=ed.get("modality", ""),
            filter_rule=ed.get("filter_rule"),
            scrub_rects=[tuple(r) for r in ed.get("scrub_rects", [])],
            tag_actions=ed.get("tag_actions", {}),
            recompressed=ed.get("recompressed", False),
            compressed_bytes=ed.get("compressed_bytes", 0),
            original_bytes=ed.get("original_bytes", 0),
            error=ed.get("error", ""),
            worker_id=ed.get("worker_id", ""),
            script_shas=ed.get("script_shas", {}),
        )


@dataclass
class Manifest:
    request_id: str
    entries: List[ManifestEntry] = field(default_factory=list)

    def add(self, entry: ManifestEntry) -> None:
        self.entries.append(entry)

    def counts(self) -> Dict[str, int]:
        out = {o.value: 0 for o in Outcome}
        for e in self.entries:
            out[e.outcome.value] += 1
        out["scrubbed"] = sum(1 for e in self.entries if e.scrub_rects)
        return out

    def merge(self, other: "Manifest") -> None:
        self.entries.extend(other.entries)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(
            {"request_id": self.request_id, "counts": self.counts(),
             "entries": [e.to_dict() for e in self.entries]},
            indent=indent,
        )

    @staticmethod
    def from_json(s: str) -> "Manifest":
        d = json.loads(s)
        m = Manifest(d["request_id"])
        for ed in d["entries"]:
            m.add(ManifestEntry.from_dict(ed))
        return m
