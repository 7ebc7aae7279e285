"""Plain reference of the de-identification a CT cohort request must give.

Written from the configuration's stated rules, in NumPy and the standard
library, and independent of the program: the pseudonyms (HMAC-SHA256 codes
and a per-patient date jitter), the anonymizer profile (explicit per-tag
rules, every other tag removed, private tags removed), the device's
burned-in regions blanked to 0, and the lossless recompression: JPEG
Lossless predictor 1 (left neighbour) and a Golomb-Rice code, packed one bit
at a time. It imports nothing of the program.
"""
from __future__ import annotations

import base64
import datetime as dt
import hashlib
import hmac
import struct
from typing import Dict, Sequence

import numpy as np

UID_ROOT = "1.2.840.99999.2.1"
JPEG_LOSSLESS = "1.2.840.10008.1.2.4.70"
QMAX = 23  # longest unary quotient; a larger one is escaped with 64 raw bits


# ------------------------------------------------------------- pseudonyms
def _code(key: bytes, kind: str, value: str) -> str:
    mac = hmac.new(key, f"{kind}|{value}".encode(), hashlib.sha256).digest()
    return base64.b32encode(mac).decode("ascii")[:10]


def pseudonyms(key: bytes, research_study: str, accession: str, mrn: str,
               jitter_days: int = 30) -> Dict[str, str]:
    """What one research study's key makes of one accession: the anonymous
    accession and MRN, and the patient's date shift (never 0 days)."""
    mac = hmac.new(key, f"jitter|{mrn}".encode(), hashlib.sha256).digest()
    v = int.from_bytes(mac[:4], "big") % (2 * jitter_days)
    jitter = v - jitter_days if v < jitter_days else v - jitter_days + 1
    anon_acc = "RA" + _code(key, "accession", accession)
    return {"accession": anon_acc, "mrn": "RP" + _code(key, "mrn", mrn), "jitter": jitter,
            "uid_salt": f"{research_study}|{anon_acc}"}


def _shift_date(da: str, days: int) -> str:
    if not da or len(da) != 8:
        return ""
    try:
        d = dt.date(int(da[:4]), int(da[4:6]), int(da[6:8])) + dt.timedelta(days=days)
    except (ValueError, OverflowError):
        return ""
    return d.strftime("%Y%m%d")


def _hash_uid(salt: str, value: str) -> str:
    h = int.from_bytes(hashlib.sha256(f"{salt}|{value}".encode()).digest()[:8], "big")
    return f"{UID_ROOT}.{h}"


# The anonymizer profile (DICOM Basic Application Confidentiality Profile
# with Clean Graphics and Retain Longitudinal Temporal Information With
# Modified Dates): each tag's action; every tag not named is removed.
KEEP = ("PatientSex", "PatientAge", "SeriesNumber", "InstanceNumber", "Modality", "Manufacturer",
        "ManufacturerModelName", "SoftwareVersions", "Rows", "Columns", "BitsAllocated",
        "BitsStored", "SamplesPerPixel", "BurnedInAnnotation", "ImageType", "ConversionType",
        "BodyPartExamined", "SOPClassUID", "TransferSyntaxUID")
SET = {"AccessionNumber": "accession", "PatientID": "mrn", "PatientName": "mrn",
       "StudyID": "accession"}
JITTER = ("StudyDate", "SeriesDate", "AcquisitionDate", "ContentDate")
EMPTY = ("StudyTime", "SeriesTime", "AcquisitionTime", "ContentTime")
HASHUID = ("SOPInstanceUID", "StudyInstanceUID", "SeriesInstanceUID")


def anonymize(elements: Dict[str, object], pseudo: Dict[str, object], recompress: bool) -> Dict[str, object]:
    """The delivered tags of one instance."""
    src = dict(elements)
    if recompress:
        src["TransferSyntaxUID"] = JPEG_LOSSLESS
    out: Dict[str, object] = {}
    for kw, val in src.items():
        if kw in KEEP:
            out[kw] = val
        elif kw in SET:
            out[kw] = str(pseudo[SET[kw]])
        elif kw in JITTER:
            out[kw] = _shift_date(str(val), int(pseudo["jitter"]))
        elif kw in EMPTY:
            out[kw] = ""
        elif kw in HASHUID:
            out[kw] = _hash_uid(str(pseudo["uid_salt"]), str(val))
    return out


# ------------------------------------------------------------------ pixels
def blank(pixels: np.ndarray, rects: Sequence[Sequence[int]]) -> np.ndarray:
    """A copy with each (x, y, w, h) region set to 0, clipped to the frame."""
    out = pixels.copy()
    H, W = out.shape[-2:]
    for x, y, w, h in rects:
        out[..., max(0, y):max(0, min(H, y + h)), max(0, x):max(0, min(W, x + w))] = 0
    return out


def encode(plane: np.ndarray) -> bytes:
    """Lossless stream of one 2D plane: header ``RJLS`` ``P`` <h w bits sv k
    nbytes>, then the Golomb-Rice code of the predictor-1 residuals."""
    H, W = plane.shape
    bits = plane.dtype.itemsize * 8
    x = plane.astype(np.int64)
    pred = np.empty_like(x)
    pred[:, 1:] = x[:, :-1]          # predictor 1: the left neighbour
    pred[1:, 0] = x[:-1, 0]          # column 0 from above
    pred[0, 0] = 1 << (bits - 1)
    r = (x - pred) & ((1 << bits) - 1)
    r = np.where(r >= 1 << (bits - 1), r - (1 << bits), r).ravel()
    u = np.where(r >= 0, 2 * r, -2 * r - 1).astype(np.int64)   # zigzag
    mean = int(u.sum()) / u.size
    k = 0
    while (1 << k) < mean + 1 and k < 30:
        k += 1
    q = u >> k
    esc = q > QMAX
    lens = np.where(esc, QMAX + 2 + 64, q + 1 + k)
    offs = np.concatenate([[0], np.cumsum(lens)])
    total = int(offs[-1])
    stream = np.zeros(total, np.uint8)
    start = offs[:-1]
    ones = np.where(esc, QMAX + 1, q)
    idx = np.repeat(start, ones) + (np.arange(ones.sum()) - np.repeat(np.cumsum(ones) - ones, ones))
    stream[idx] = 1                   # unary quotient (escape: QMAX + 1 ones), then a 0
    ne = ~esc
    for j in range(k):                # k remainder bits, most significant first
        stream[start[ne] + q[ne] + 1 + j] = (u[ne] >> (k - 1 - j)) & 1
    if esc.any():
        for j in range(64):           # the escaped value, 64 raw bits
            stream[start[esc] + QMAX + 2 + j] = (u[esc] >> (63 - j)) & 1
    payload = np.packbits(stream).tobytes()
    return b"RJLS" + b"P" + struct.pack("<IIBBBI", H, W, bits, 1, k, len(payload)) + payload
