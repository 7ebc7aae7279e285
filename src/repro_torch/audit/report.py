"""Accounting of disclosures: aggregate the ledger into a PHI-safe report.

HIPAA's "accounting of disclosures" shape: *who received which bytes, derived
from which source version, under which ruleset/detector*. The
:class:`DisclosureReport` folds the ledger's ``provenance`` records into
per-project accounting plus lake/dead-letter totals; every exported line
crosses the existing telemetry :class:`~repro_torch.obs.export.Redactor`, so the
report inherits the same allowlist PHI boundary as spans and metrics.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.audit.records import (
    DEAD_LETTER,
    DEID_EXECUTE,
    LAKE_EVICT,
    LAKE_HIT,
    LAKE_WRITE,
    PROVENANCE,
    canonical,
)
from repro_torch.obs.export import Redactor


@dataclass
class ProjectAccounting:
    """Disclosure rollup for one research project."""

    project: str
    deliveries: int = 0
    instances: int = 0
    nbytes: int = 0
    cold: int = 0          # deliveries that ran the kernels
    warm: int = 0          # deliveries served from the result lake
    journal: int = 0       # deliveries answered from the completion journal
    accessions: set = field(default_factory=set)
    rulesets: set = field(default_factory=set)
    first_t: float = 0.0
    last_t: float = 0.0

    def to_dict(self) -> dict:
        return {
            "project": self.project,
            "deliveries": self.deliveries,
            "instances": self.instances,
            "nbytes": self.nbytes,
            "cold": self.cold,
            "warm": self.warm,
            "journal": self.journal,
            "accessions": sorted(self.accessions),
            "rulesets": sorted(self.rulesets),
            "first_t": self.first_t,
            "last_t": self.last_t,
        }


@dataclass
class DisclosureReport:
    projects: Dict[str, ProjectAccounting] = field(default_factory=dict)
    deid_executions: int = 0
    lake_writes: int = 0
    lake_hits: int = 0
    lake_evictions: int = 0
    lake_bytes_in: int = 0
    lake_bytes_out: int = 0
    dead_lettered: int = 0
    ledger_records: int = 0
    ledger_digest: str = ""

    @classmethod
    def from_ledger(cls, ledger) -> "DisclosureReport":
        rep = cls(ledger_records=len(ledger), ledger_digest=ledger.digest())
        for rec in ledger.records():
            kind = rec.get("kind")
            if kind == PROVENANCE:
                proj = str(rec.get("project", ""))
                acct = rep.projects.get(proj)
                if acct is None:
                    acct = rep.projects[proj] = ProjectAccounting(
                        project=proj, first_t=rec.get("t", 0.0)
                    )
                acct.deliveries += 1
                acct.instances += int(rec.get("instances", 0))
                acct.nbytes += int(rec.get("nbytes", 0))
                temp = rec.get("temp", "cold")
                if temp == "warm":
                    acct.warm += 1
                elif temp == "journal":
                    acct.journal += 1
                else:
                    acct.cold += 1
                acct.accessions.add(str(rec.get("accession", "")))
                if rec.get("ruleset"):
                    acct.rulesets.add(str(rec["ruleset"]))
                acct.last_t = rec.get("t", acct.last_t)
            elif kind == DEID_EXECUTE:
                rep.deid_executions += 1
            elif kind == LAKE_WRITE:
                rep.lake_writes += 1
                rep.lake_bytes_in += int(rec.get("nbytes", 0))
            elif kind == LAKE_HIT:
                rep.lake_hits += 1
                rep.lake_bytes_out += int(rec.get("nbytes", 0))
            elif kind == LAKE_EVICT:
                rep.lake_evictions += 1
            elif kind == DEAD_LETTER:
                rep.dead_lettered += 1
        return rep

    def to_dict(self) -> dict:
        return {
            "projects": {p: a.to_dict() for p, a in sorted(self.projects.items())},
            "deid_executions": self.deid_executions,
            "lake_writes": self.lake_writes,
            "lake_hits": self.lake_hits,
            "lake_evictions": self.lake_evictions,
            "lake_bytes_in": self.lake_bytes_in,
            "lake_bytes_out": self.lake_bytes_out,
            "dead_lettered": self.dead_lettered,
            "ledger_records": self.ledger_records,
            "ledger_digest": self.ledger_digest,
        }

    def to_jsonl(self, redactor: Redactor) -> str:
        """One redacted JSON line per project, then one totals line. Every
        per-project attribute dict crosses the redactor allowlist, same as a
        span's attrs — free text planted in the ledger cannot survive."""
        lines: List[str] = []
        for _, acct in sorted(self.projects.items()):
            lines.append(json.dumps(
                canonical(redactor.attrs(acct.to_dict())),
                sort_keys=True, separators=(",", ":")))
        totals = self.to_dict()
        totals.pop("projects")
        lines.append(json.dumps(
            canonical({"totals": redactor.attrs(totals)}),
            sort_keys=True, separators=(",", ":")))
        return "\n".join(lines) + "\n"

    def summary(self) -> str:
        """Human-readable accounting, for the example epilogue / operators."""
        out = [
            f"disclosure report — {self.ledger_records} ledger records, "
            f"digest {self.ledger_digest[:12]}…",
            f"  lake: {self.lake_writes} writes ({self.lake_bytes_in} B in), "
            f"{self.lake_hits} hits ({self.lake_bytes_out} B out), "
            f"{self.lake_evictions} evictions",
            f"  deid executions: {self.deid_executions}; "
            f"dead-lettered: {self.dead_lettered}",
        ]
        for _, acct in sorted(self.projects.items()):
            out.append(
                f"  project {acct.project or '<none>'}: {acct.deliveries} deliveries "
                f"({acct.cold} cold / {acct.warm} warm / {acct.journal} journal), "
                f"{acct.instances} instances, {acct.nbytes} B, "
                f"{len(acct.accessions)} accessions, "
                f"{len(acct.rulesets)} ruleset(s)"
            )
        return "\n".join(out)


def export_ledger_jsonl(ledger, redactor: Redactor) -> str:
    """Redacted JSONL dump of the full ledger. Structural chain fields
    (kind/seq/t/prev_sha/sha) are code-controlled and pass as-is — like span
    ids — while every payload attribute crosses the redactor allowlist."""
    lines: List[str] = []
    for rec in ledger.records():
        structural = {k: rec[k] for k in ("kind", "seq", "t", "prev_sha", "sha") if k in rec}
        payload = {k: v for k, v in rec.items() if k not in structural}
        out = {**structural, **redactor.attrs(payload)}
        lines.append(json.dumps(canonical(out), sort_keys=True, separators=(",", ":")))
    return "\n".join(lines) + ("\n" if lines else "")
