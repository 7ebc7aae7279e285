"""In-memory DICOM dataset model.

A :class:`DicomDataset` is an ordered mapping of keyword -> value plus an
optional pixel array (numpy, HxW or HxWxC). Private tags (odd groups) are kept
in a separate ``private`` dict keyed by (group, element) hex strings, because
the de-identification engine treats them categorically (remove-all unless
whitelisted), mirroring CTP's behaviour.

The dataset is deliberately *not* a torch type: metadata handling is host-side
control plane. Pixel data crosses onto the device only inside the scrub stage.
"""
from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.dicom.tags import TAGS

_UID_ROOT = "1.2.840.99999.2.1"  # research root, not a registered OID
_uid_counter = itertools.count(1)


def normalize_cs(value: Any) -> str:
    """Normalize a CS-like string value for comparison: collapse internal
    whitespace runs, strip, uppercase. DICOM CS values are case-insensitive
    and frequently space-padded by devices; every metadata comparison in the
    engine (filter rules, catalog dictionary encoding) goes through this one
    function so the two layers can never disagree about what "equal" means."""
    return " ".join(str(value).split()).upper()


def new_uid(entropy: Optional[str] = None) -> str:
    """Generate a DICOM UID. Deterministic when ``entropy`` is given."""
    if entropy is not None:
        h = int.from_bytes(hashlib.sha256(entropy.encode()).digest()[:8], "big")
        return f"{_UID_ROOT}.{h}"
    return f"{_UID_ROOT}.{next(_uid_counter)}"


@dataclass
class DicomDataset:
    """One SOP instance (a single DICOM image/object)."""

    elements: Dict[str, Any] = field(default_factory=dict)
    private: Dict[str, Any] = field(default_factory=dict)
    pixels: Optional[np.ndarray] = None
    # Encapsulated payload for non-image objects (PDF/SR), mirrors real DICOM.
    encapsulated: Optional[bytes] = None

    # -- mapping-ish interface ----------------------------------------------
    def get(self, keyword: str, default: Any = None) -> Any:
        return self.elements.get(keyword, default)

    def __getitem__(self, keyword: str) -> Any:
        return self.elements[keyword]

    def __setitem__(self, keyword: str, value: Any) -> None:
        if keyword not in TAGS:
            raise KeyError(f"unknown DICOM keyword {keyword!r}; add it to repro_torch.dicom.tags")
        self.elements[keyword] = value

    def __contains__(self, keyword: str) -> bool:
        return keyword in self.elements

    def __delitem__(self, keyword: str) -> None:
        del self.elements[keyword]

    def keys(self) -> Iterator[str]:
        return iter(self.elements.keys())

    def pop(self, keyword: str, default: Any = None) -> Any:
        return self.elements.pop(keyword, default)

    # -- helpers ---------------------------------------------------------------
    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        return None if self.pixels is None else tuple(self.pixels.shape)

    def nbytes(self) -> int:
        n = sum(len(str(v)) for v in self.elements.values())
        if self.pixels is not None:
            n += self.pixels.nbytes
        if self.encapsulated is not None:
            n += len(self.encapsulated)
        return n

    def matches(self, keyword: str, value: Any) -> bool:
        """Case/whitespace-insensitive equality against a tag value (CS-like
        semantics via :func:`normalize_cs`). False when the tag is absent.
        Shared by the filter stage's equals/notequals/in ops and the catalog's
        dictionary encoding."""
        if keyword not in self.elements:
            return False
        return normalize_cs(self.elements[keyword]) == normalize_cs(value)

    def image_type_contains(self, token: str) -> bool:
        it = self.get("ImageType", "")
        parts = it.split("\\") if isinstance(it, str) else list(it)
        return token.upper() in [p.upper() for p in parts]

    def resolution(self) -> Optional[Tuple[int, int]]:
        r, c = self.get("Rows"), self.get("Columns")
        if r is None or c is None:
            return None
        return int(r), int(c)

    def copy(self) -> "DicomDataset":
        return DicomDataset(
            elements=dict(self.elements),
            private=dict(self.private),
            pixels=None if self.pixels is None else self.pixels.copy(),
            encapsulated=self.encapsulated,
        )

    def summary(self) -> str:
        return (
            f"<DicomDataset {self.get('Modality','?')} {self.get('Manufacturer','?')}"
            f"/{self.get('ManufacturerModelName','?')} {self.shape} "
            f"sop={self.get('SOPInstanceUID','?')[-8:]}>"
        )
