"""Per-instance detection reports and aggregate counters (auditing).

A :class:`DetectionReport` is attached to every :class:`ScrubResult` the
scrub stage produces while a :class:`DetectorPolicy` is active — it records
what the registry knew, whether the detector ran, under which thresholds,
and which rectangles were ultimately applied. The fleet surfaces the
aggregate :class:`DetectStats` as worker metrics (unknown-device lookups
are a first-class signal, not a silent pass-through).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from repro_torch.dicom.devices import Rect
from repro_torch.detect.policy import DETECTOR_VERSION
from repro_torch.obs.metrics import StatsShim

Band = Tuple[int, int]


@dataclass
class DetectionReport:
    """Everything one instance's rect resolution decided, for auditing."""

    sop_uid: str = ""
    modality: str = ""
    device: str = ""                 # DeviceKey.id() of the instance's tags
    registry_hit: bool = False
    detector_ran: bool = False
    ceiling: float = 0.0             # stored sample ceiling used
    thresh: float = 0.0              # binarization threshold used
    tau: float = 0.0                 # row-fraction threshold used
    bands: List[Band] = field(default_factory=list)
    detector_rects: List[Rect] = field(default_factory=list)
    registry_rects: List[Rect] = field(default_factory=list)
    applied_rects: List[Rect] = field(default_factory=list)
    version: str = DETECTOR_VERSION

    @property
    def detected(self) -> bool:
        """True when the detector ran and proposed at least one band."""
        return self.detector_ran and bool(self.bands)


class DetectStats(StatsShim):
    """Aggregate scrub-stage counters (worker metrics pull deltas of these).

    Attribute surface is unchanged; values are ``repro_detect_*`` counters so
    a shared registry sees the fleet-wide totals across pipelines.
    """

    _SUBSYSTEM = "detect"
    _FIELDS = (
        "instances",        # instances that went through rect resolution
        "registry_hits",    # resolved from the scrub script / registry
        "unknown_lookups",  # registry misses (unknown manufacturer/model)
        "detector_runs",    # instances the detector actually scanned
        "detected",         # scans that proposed at least one band
        "bands",            # total bands proposed
    )
