"""Minimal DICOM data-dictionary: the tags the de-identification engine touches.

This is intentionally a *registry*, not a full PS3.6 dictionary: the paper's
pipeline only needs the identification-relevant subset plus the structural
attributes used by filter rules. Tags are addressed by keyword throughout the
codebase; ``(group, element)`` and VR are kept for fidelity (hex round-trips in
manifests, group-based rules like "remove all private groups").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class TagInfo:
    group: int
    element: int
    vr: str  # DICOM value representation, e.g. PN, LO, DA, UI, US, CS
    keyword: str

    @property
    def tag(self) -> Tuple[int, int]:
        return (self.group, self.element)

    def hex(self) -> str:
        return f"({self.group:04X},{self.element:04X})"


def _t(group: int, element: int, vr: str, keyword: str) -> TagInfo:
    return TagInfo(group, element, vr, keyword)


# --- Identity / demographics (HIPAA identifiers) -------------------------------
_ALL = [
    _t(0x0008, 0x0050, "SH", "AccessionNumber"),
    _t(0x0010, 0x0010, "PN", "PatientName"),
    _t(0x0010, 0x0020, "LO", "PatientID"),  # MRN
    _t(0x0010, 0x0030, "DA", "PatientBirthDate"),
    _t(0x0010, 0x0032, "TM", "PatientBirthTime"),
    _t(0x0010, 0x0040, "CS", "PatientSex"),
    _t(0x0010, 0x1000, "LO", "OtherPatientIDs"),
    _t(0x0010, 0x1001, "PN", "OtherPatientNames"),
    _t(0x0010, 0x1010, "AS", "PatientAge"),
    _t(0x0010, 0x1040, "LO", "PatientAddress"),
    _t(0x0010, 0x2154, "SH", "PatientTelephoneNumbers"),
    _t(0x0010, 0x21B0, "LT", "AdditionalPatientHistory"),
    _t(0x0008, 0x0090, "PN", "ReferringPhysicianName"),
    _t(0x0008, 0x1048, "PN", "PhysiciansOfRecord"),
    _t(0x0008, 0x1050, "PN", "PerformingPhysicianName"),
    _t(0x0008, 0x1070, "PN", "OperatorsName"),
    _t(0x0008, 0x0080, "LO", "InstitutionName"),
    _t(0x0008, 0x0081, "ST", "InstitutionAddress"),
    _t(0x0008, 0x1040, "LO", "InstitutionalDepartmentName"),
    # --- Dates / times (longitudinal temporal info, jittered not removed) -----
    _t(0x0008, 0x0020, "DA", "StudyDate"),
    _t(0x0008, 0x0021, "DA", "SeriesDate"),
    _t(0x0008, 0x0022, "DA", "AcquisitionDate"),
    _t(0x0008, 0x0023, "DA", "ContentDate"),
    _t(0x0008, 0x0030, "TM", "StudyTime"),
    _t(0x0008, 0x0031, "TM", "SeriesTime"),
    _t(0x0008, 0x0032, "TM", "AcquisitionTime"),
    _t(0x0008, 0x0033, "TM", "ContentTime"),
    # --- Structure / UIDs -------------------------------------------------------
    _t(0x0008, 0x0016, "UI", "SOPClassUID"),
    _t(0x0008, 0x0018, "UI", "SOPInstanceUID"),
    _t(0x0020, 0x000D, "UI", "StudyInstanceUID"),
    _t(0x0020, 0x000E, "UI", "SeriesInstanceUID"),
    _t(0x0020, 0x0010, "SH", "StudyID"),
    _t(0x0020, 0x0011, "IS", "SeriesNumber"),
    _t(0x0020, 0x0013, "IS", "InstanceNumber"),
    # --- Equipment (filter/scrub rule keys) ------------------------------------
    _t(0x0008, 0x0060, "CS", "Modality"),
    _t(0x0008, 0x0070, "LO", "Manufacturer"),
    _t(0x0008, 0x1090, "LO", "ManufacturerModelName"),
    _t(0x0018, 0x1000, "LO", "DeviceSerialNumber"),
    _t(0x0018, 0x1020, "LO", "SoftwareVersions"),
    _t(0x0008, 0x1010, "SH", "StationName"),
    # --- Image structure --------------------------------------------------------
    _t(0x0028, 0x0010, "US", "Rows"),
    _t(0x0028, 0x0011, "US", "Columns"),
    _t(0x0028, 0x0100, "US", "BitsAllocated"),
    _t(0x0028, 0x0101, "US", "BitsStored"),
    _t(0x0028, 0x0002, "US", "SamplesPerPixel"),
    _t(0x0028, 0x0301, "CS", "BurnedInAnnotation"),
    _t(0x0008, 0x0008, "CS", "ImageType"),
    _t(0x0008, 0x0064, "CS", "ConversionType"),
    _t(0x0008, 0x103E, "LO", "SeriesDescription"),
    _t(0x0008, 0x1030, "LO", "StudyDescription"),
    _t(0x0018, 0x0015, "CS", "BodyPartExamined"),
    _t(0x0002, 0x0010, "UI", "TransferSyntaxUID"),
    _t(0x7FE0, 0x0010, "OW", "PixelData"),
    # --- Misc free text (PHI leak vectors) --------------------------------------
    _t(0x0008, 0x4000, "LT", "IdentifyingComments"),
    _t(0x0010, 0x4000, "LT", "PatientComments"),
    _t(0x0020, 0x4000, "LT", "ImageComments"),
    _t(0x0032, 0x1060, "LO", "RequestedProcedureDescription"),
    _t(0x0040, 0x0254, "LO", "PerformedProcedureStepDescription"),
]

TAGS: Dict[str, TagInfo] = {t.keyword: t for t in _ALL}
_BY_TAG: Dict[Tuple[int, int], TagInfo] = {t.tag: t for t in _ALL}

# Tag groups used by rule scripts.
UID_KEYWORDS = [k for k, t in TAGS.items() if t.vr == "UI" and k != "TransferSyntaxUID"]
DATE_KEYWORDS = [k for k, t in TAGS.items() if t.vr == "DA"]
TIME_KEYWORDS = [k for k, t in TAGS.items() if t.vr == "TM"]
PERSON_KEYWORDS = [k for k, t in TAGS.items() if t.vr == "PN"]
FREETEXT_KEYWORDS = [k for k, t in TAGS.items() if t.vr in ("LT", "ST")]


def keyword_for(tag: Tuple[int, int]) -> Optional[str]:
    info = _BY_TAG.get(tag)
    return info.keyword if info else None


def is_private(tag: Tuple[int, int]) -> bool:
    """Private DICOM tags have odd group numbers."""
    return tag[0] % 2 == 1
