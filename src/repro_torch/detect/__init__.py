"""Burned-in pixel-PHI detection subsystem.

Registry-fallback text-band detection: ``kernels/textdetect`` reduces pixels
to projection profiles (a CUDA kernel on the card, the bit-identical numpy
oracle on the host), ``regions`` turns profiles into full-width blank
rectangles, ``policy`` decides when the detector runs (registry-first /
union / off) and versions the behavior into the ruleset fingerprint,
``report`` carries the per-instance audit trail.
"""
from repro_torch.detect.policy import DETECTOR_VERSION, DetectorPolicy
from repro_torch.detect.regions import (
    bands_from_hits,
    detect_bands_for,
    detect_bands_np,
    merge_rects,
    policy_thresh,
    rects_from_bands,
)
from repro_torch.detect.report import DetectionReport, DetectStats

__all__ = [
    "DETECTOR_VERSION",
    "DetectorPolicy",
    "DetectionReport",
    "DetectStats",
    "bands_from_hits",
    "detect_bands_for",
    "detect_bands_np",
    "merge_rects",
    "policy_thresh",
    "rects_from_bands",
]
