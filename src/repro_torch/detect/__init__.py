"""Detector policy and audit report. The text-band detector itself is not
ported yet: an enabled policy raises in the scrub stage."""
from repro_torch.detect.policy import DETECTOR_VERSION, DetectorPolicy
from repro_torch.detect.report import DetectionReport, DetectStats

__all__ = ["DETECTOR_VERSION", "DetectorPolicy", "DetectionReport", "DetectStats"]
