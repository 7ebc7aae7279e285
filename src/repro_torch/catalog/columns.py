"""Ingest-time columnar encoding of DICOM metadata (DESIGN.md §8).

A catalog row is one SOP instance. String-ish tags (CS/LO) are
dictionary-encoded to int32 codes through the same ``normalize_cs``
normalization the filter stage uses — the catalog and the filter can never
disagree about string equality. Numeric tags are stored as int32 directly
(StudyDate as the yyyymmdd integer, so date ranges are integer ranges).

Rows are grouped into fixed-size blocks. Each sealed block carries a zone
map per column: [min, max] for numeric columns, a 64-bit bloom-lite code
mask for dictionary columns. Zone maps are computed at seal time over every
row the block ever held, so tombstoning rows (re-ingest) keeps them
conservative — pruning may scan a dead block, never skip a live row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.dicom.dataset import DicomDataset, normalize_cs

# column name -> kind. "dict": dictionary-encoded normalized string;
# "int": raw int32 value. The query AST validates against this schema.
COLUMN_KINDS: Dict[str, str] = {
    "modality": "dict",
    "body_part": "dict",
    "manufacturer": "dict",
    "model": "dict",
    "study_date": "int",
    "bits_stored": "int",
    "rows": "int",
    "cols": "int",
    "nbytes": "int",
    "burned_in": "int",
    # detector-oracle verdict over the *source* pixels at ingest: 1 when the
    # text-band detector (default policy knobs) proposes at least one band.
    # Complements the self-declared BurnedInAnnotation tag — devices lie
    # about burn-in far more often than pixels do (DESIGN.md §9).
    "burned_in_detected": "int",
}
COLUMNS: Tuple[str, ...] = tuple(COLUMN_KINDS)
DICT_COLUMNS: Tuple[str, ...] = tuple(c for c, k in COLUMN_KINDS.items() if k == "dict")


def date_int(value: Any) -> int:
    """DICOM DA string -> yyyymmdd integer (0 when absent/malformed)."""
    digits = "".join(ch for ch in str(value) if ch.isdigit())
    return int(digits[:8]) if digits else 0


def burned_in_detected(ds: DicomDataset) -> int:
    """Detector-oracle verdict for one instance's pixels (0 for pixel-less
    or multi-plane objects). Pure numpy at scan time; the import is lazy so
    the catalog module does not load the detector until ingest needs it."""
    pix = ds.pixels
    if pix is None or getattr(pix, "ndim", 0) != 2:
        return 0
    from repro_torch.detect import DetectorPolicy, detect_bands_for

    bands, _ = detect_bands_for(ds, DetectorPolicy())
    return int(bool(bands))


def row_from_dataset(ds: DicomDataset) -> Dict[str, Any]:
    """Extract one catalog row from a dataset. Raw (unnormalized) strings —
    normalization happens at dictionary-encode time, and the brute-force
    oracle (`query.matches_row`) normalizes on its side, so both paths see
    the same values the same way."""
    res = ds.resolution() or (0, 0)
    return {
        "modality": str(ds.get("Modality", "")),
        "body_part": str(ds.get("BodyPartExamined", "")),
        "manufacturer": str(ds.get("Manufacturer", "")),
        "model": str(ds.get("ManufacturerModelName", "")),
        "study_date": date_int(ds.get("StudyDate", "")),
        "bits_stored": int(ds.get("BitsStored", 0) or 0),
        "rows": int(res[0]),
        "cols": int(res[1]),
        "nbytes": int(ds.nbytes()),
        "burned_in": int(normalize_cs(ds.get("BurnedInAnnotation", "")) == "YES"),
        "burned_in_detected": burned_in_detected(ds),
    }


def rows_from_study(study) -> List[Dict[str, Any]]:
    """Catalog rows for every instance of a :class:`SyntheticStudy`."""
    return [row_from_dataset(ds) for ds in study.datasets]


class Dictionary:
    """Incremental string dictionary: normalized value <-> int32 code."""

    __slots__ = ("values", "codes")

    def __init__(self) -> None:
        self.values: List[str] = []
        self.codes: Dict[str, int] = {}

    def encode(self, raw: Any) -> int:
        v = normalize_cs(raw)
        code = self.codes.get(v)
        if code is None:
            code = len(self.values)
            self.codes[v] = code
            self.values.append(v)
        return code

    def code_of(self, raw: Any) -> Optional[int]:
        """Code for a query literal; None when the value was never ingested
        (the query can then match nothing — a pruning fact, not an error)."""
        return self.codes.get(normalize_cs(raw))

    def decode(self, code: int) -> str:
        return self.values[code]

    def codes_containing(self, needle: Any) -> Tuple[int, ...]:
        """All codes whose decoded value contains the normalized needle —
        free-text Contains compiles down to an In over these codes."""
        nv = normalize_cs(needle)
        return tuple(c for c, v in enumerate(self.values) if nv in v)

    def __len__(self) -> int:
        return len(self.values)


def bloom_bit(code: int) -> int:
    """64-bit bloom-lite position for a dictionary code (Knuth multiplicative
    mix — codes are small sequential ints, so unmixed modulo would alias
    neighbouring values into runs)."""
    return (code * 2654435761) % 64


@dataclass(frozen=True)
class ZoneMap:
    lo: int
    hi: int
    bloom: int  # 64-bit code mask, dictionary columns only (0 for int cols)


@dataclass
class Block:
    """One sealed (or open-view) block: column arrays + validity + zone maps.

    ``zmaps`` is None for the open-block view — an unsealed block has no zone
    maps yet and is always scanned.
    """

    cols: Dict[str, np.ndarray]      # column -> (n,) int32
    acc: np.ndarray                  # (n,) int32 accession codes
    valid: np.ndarray                # (n,) bool, False = tombstoned
    zmaps: Optional[Dict[str, ZoneMap]]

    @property
    def n(self) -> int:
        return int(self.acc.shape[0])

    def n_valid(self) -> int:
        return int(self.valid.sum())


def build_zone_maps(cols: Dict[str, np.ndarray]) -> Dict[str, ZoneMap]:
    zmaps: Dict[str, ZoneMap] = {}
    for name, arr in cols.items():
        lo = int(arr.min()) if arr.size else 0
        hi = int(arr.max()) if arr.size else -1
        bloom = 0
        if COLUMN_KINDS[name] == "dict":
            for code in np.unique(arr):
                bloom |= 1 << bloom_bit(int(code))
        zmaps[name] = ZoneMap(lo, hi, bloom)
    return zmaps


def seal_block(
    cols: Dict[str, Sequence[int]], acc: Sequence[int], valid: Sequence[bool]
) -> Block:
    arrays = {name: np.asarray(vals, np.int32) for name, vals in cols.items()}
    return Block(
        cols=arrays,
        acc=np.asarray(acc, np.int32),
        valid=np.asarray(valid, bool),
        zmaps=build_zone_maps(arrays),
    )
