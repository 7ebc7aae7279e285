"""DetectorPolicy: when the detector runs and how confident it must be.

The policy is the versioned contract between the device registry and the
pixel-PHI detector (DESIGN.md §9):

* ``registry_first`` (default) — registry geometry wins when the (modality,
  manufacturer, model, resolution) variant is known; the detector runs only
  on registry *misses* (unknown devices), which is exactly the gap that used
  to pass pixels through silently.
* ``union`` — the detector always runs and its bands are merged with the
  registry rects (belt and braces, e.g. while qualifying a new ruleset).
* ``off`` — registry-only, the pre-detector behavior. This is the negative
  control the sim's PHI-boundary invariant is tested against.

Ultrasound stays whitelist-only in every mode (paper Table 2): an unknown US
variant is rejected by the filter and fails closed in the scrub stage — the
detector is a complement to the whitelist, never a bypass of it.

The policy digests into :class:`repro_torch.lake.fingerprint.RulesetFingerprint`
(together with :data:`DETECTOR_VERSION`), so editing a threshold — or
shipping a new detector — structurally invalidates every cached de-id result
minted under the old behavior.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Tuple

# Bumped whenever kernel/oracle/band-extraction semantics change: the version
# rides the ruleset fingerprint, so a new detector forces a cold serve.
DETECTOR_VERSION = "textdetect-v1"

MODES = ("off", "registry_first", "union")

# Glyph strokes are burned at (or near) the stored sample ceiling; anatomy in
# this corpus tops out around half of it. Binarizing at 60% of the ceiling
# keeps the hit mask empty on clean tissue and dense on burned-in text. This
# is THE binarize fraction — ``kernels/textdetect/ops`` and the policy
# default both read it, so direct kernel users and the pipeline can never
# silently diverge.
DEFAULT_BINARIZE_FRAC = 0.6


@dataclass(frozen=True)
class DetectorPolicy:
    """Frozen (hashable, digestable) detector configuration.

    ``row_frac`` is the default per-row glyph-hit fraction a row must clear
    to count as text; ``modality_row_frac`` overrides it per modality (e.g.
    a stricter threshold for DX where bright hardware edges are common).
    ``binarize_frac`` scales the dtype/BitsStored ceiling into the glyph
    threshold (see :data:`DEFAULT_BINARIZE_FRAC` rationale).
    """

    mode: str = "registry_first"
    binarize_frac: float = DEFAULT_BINARIZE_FRAC
    row_frac: float = 0.04
    modality_row_frac: Tuple[Tuple[str, float], ...] = ()
    min_band_rows: int = 2
    pad_rows: int = 2
    tile: Tuple[int, int] = (32, 128)

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"unknown detector mode {self.mode!r}; one of {MODES}")

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def wants_detection(self, registry_hit: bool) -> bool:
        """Should the detector run for an instance with/without a registry
        scrub rule? (US never reaches here on a miss — it fails closed.)"""
        if self.mode == "union":
            return True
        if self.mode == "registry_first":
            return not registry_hit
        return False

    def tau_for(self, modality: str) -> float:
        for mod, frac in self.modality_row_frac:
            if mod == modality:
                return frac
        return self.row_frac

    @property
    def fingerprint_identity(self) -> str:
        """What the ruleset fingerprint folds in. ``mode="off"`` maps to the
        empty (pre-detector) identity: delivered bytes are provably those of
        a policy-less pipeline (tested), so a fleet staging the detector
        dark must keep serving its lake warm — and the other knobs are
        irrelevant while off, so they must not invalidate anything either."""
        return self.digest if self.enabled else ""

    @property
    def digest(self) -> str:
        """Stable identity of (detector version, policy knobs) — the value
        folded into the ruleset fingerprint (via :attr:`fingerprint_identity`)."""
        canon = "|".join(
            [
                DETECTOR_VERSION,
                self.mode,
                repr(self.binarize_frac),
                repr(self.row_frac),
                repr(tuple(sorted(self.modality_row_frac))),
                repr(self.min_band_rows),
                repr(self.pad_rows),
                repr(tuple(self.tile)),
            ]
        )
        return hashlib.sha256(canon.encode()).hexdigest()
