"""Carry studies across from plain Python and numpy values.

The system has no weights: its state is the study (tags, private tags,
pixels) and the script texts, which are the same strings in every
implementation. :func:`study_to_plain` reads any object with the
``SyntheticStudy``/``DicomDataset`` attribute names into dicts, tuples and
numpy arrays, and :func:`study_from_plain` builds this package's objects
from them, so a study made elsewhere can be de-identified here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from repro_torch.dicom.dataset import DicomDataset
from repro_torch.dicom.devices import DeviceKey
from repro_torch.dicom.generator import SyntheticStudy


def dataset_from_plain(
    tags: Dict[str, Any],
    private: Dict[str, Any],
    pixels: Optional[np.ndarray],
    encapsulated: Optional[bytes] = None,
) -> DicomDataset:
    """A dataset with copies of the given tags, private tags and pixels."""
    ds = DicomDataset(
        private=dict(private),
        pixels=None if pixels is None else np.array(pixels, copy=True),
        encapsulated=encapsulated,
    )
    for keyword, value in tags.items():
        ds[keyword] = value  # validates the keyword against the tag table
    return ds


def dataset_to_plain(ds) -> Dict[str, Any]:
    return {
        "tags": dict(ds.elements),
        "private": dict(ds.private),
        "pixels": None if ds.pixels is None else np.array(ds.pixels, copy=True),
        "encapsulated": ds.encapsulated,
    }


def study_to_plain(study) -> Dict[str, Any]:
    d = study.device
    return {
        "accession": study.accession,
        "mrn": study.mrn,
        "patient_name": study.patient_name,
        "study_uid": study.study_uid,
        "study_date": study.study_date,
        "modality": study.modality,
        "device": (d.modality, d.make, d.model, int(d.rows), int(d.cols)),
        "body_part": study.body_part,
        "datasets": [dataset_to_plain(ds) for ds in study.datasets],
        "phi_rects": {k: [tuple(r) for r in v] for k, v in study.phi_rects.items()},
    }


def study_from_plain(plain: Dict[str, Any]) -> SyntheticStudy:
    """The inverse of :func:`study_to_plain`, into this package's types."""
    return SyntheticStudy(
        accession=plain["accession"],
        mrn=plain["mrn"],
        patient_name=plain["patient_name"],
        study_uid=plain["study_uid"],
        study_date=plain["study_date"],
        modality=plain["modality"],
        device=DeviceKey(*plain["device"]),
        body_part=plain.get("body_part", ""),
        datasets=[dataset_from_plain(**d) for d in plain["datasets"]],
        phi_rects={k: [tuple(r) for r in v] for k, v in plain.get("phi_rects", {}).items()},
    )
