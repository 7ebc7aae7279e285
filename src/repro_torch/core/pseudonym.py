"""Pseudonymization service: anonymized codes + date jitter (paper §Method).

Two trust modes, exactly as the paper defines them:

* **PRE_IRB** (non-human-subject research): codes are derived from an
  *ephemeral* random key that is never persisted — "can never be reversed and
  linked to identified patient data".
* **POST_IRB**: codes are derived from a per-research-study key and a linkage
  map is retained, so the IRB-approved study can "request links between the
  anonymized images and the original patient identifiers".

Date jitter is randomized **per (research study, patient)** and applied to all
dates of that patient uniformly — this keeps longitudinal intervals intact
(DICOM Retain Longitudinal Temporal Information With Modified Dates option)
while decorrelating absolute dates across research studies.
"""
from __future__ import annotations

import base64
import datetime as _dt
import hashlib
import hmac
import os
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Optional


class TrustMode(Enum):
    PRE_IRB = "pre_irb"
    POST_IRB = "post_irb"


def _code(key: bytes, kind: str, value: str, n: int = 10) -> str:
    mac = hmac.new(key, f"{kind}|{value}".encode(), hashlib.sha256).digest()
    return base64.b32encode(mac).decode("ascii")[:n]


@dataclass
class PseudonymService:
    study_id: str  # the research study (IRB protocol), not the imaging study
    mode: TrustMode = TrustMode.POST_IRB
    key: Optional[bytes] = None
    jitter_days: int = 30  # jitter drawn from [-jitter_days, +jitter_days] \ {0}
    _links: Dict[str, str] = field(default_factory=dict)  # anon -> original

    def __post_init__(self) -> None:
        if self.key is None:
            if self.mode is TrustMode.PRE_IRB:
                # ephemeral, never persisted: irreversibility by construction
                self.key = os.urandom(32)
            else:
                raise ValueError("POST_IRB mode requires a persistent study key")

    # ----------------------------------------------------------------- codes
    def accession(self, original: str) -> str:
        anon = "RA" + _code(self.key, "accession", original)
        self._maybe_link(anon, original)
        return anon

    def mrn(self, original: str) -> str:
        anon = "RP" + _code(self.key, "mrn", original)
        self._maybe_link(anon, original)
        return anon

    def _maybe_link(self, anon: str, original: str) -> None:
        if self.mode is TrustMode.POST_IRB:
            self._links[anon] = original

    def relink(self, anon: str) -> str:
        """IRB-approved reverse lookup. Forbidden (empty map) in PRE_IRB."""
        if self.mode is not TrustMode.POST_IRB:
            raise PermissionError("re-identification is not permitted for pre-IRB data")
        return self._links[anon]

    def linkage_table(self) -> Dict[str, str]:
        if self.mode is not TrustMode.POST_IRB:
            raise PermissionError("no linkage table exists for pre-IRB data")
        return dict(self._links)

    # ---------------------------------------------------------------- jitter
    def jitter_for(self, mrn: str) -> int:
        """Deterministic per-(study, patient) jitter, never zero."""
        mac = hmac.new(self.key, f"jitter|{mrn}".encode(), hashlib.sha256).digest()
        span = 2 * self.jitter_days  # values 0..2J-1 -> [-J..-1, 1..J]
        v = int.from_bytes(mac[:4], "big") % span
        return v - self.jitter_days if v < self.jitter_days else v - self.jitter_days + 1

    @staticmethod
    def jitter_date(da: str, days: int) -> str:
        """Apply jitter to a DICOM DA (YYYYMMDD) value. Malformed or
        calendar-overflowing values are emptied (fail closed: a date we cannot
        jitter must not pass through identified)."""
        if not da or len(da) != 8:
            return ""
        try:
            d = _dt.date(int(da[:4]), int(da[4:6]), int(da[6:8])) + _dt.timedelta(days=days)
        except (ValueError, OverflowError):
            return ""
        return d.strftime("%Y%m%d")
