"""Wire formats for lake entries.

Two record kinds live in the lake:

* **instance records** — one per SOP instance: the delivered (de-identified)
  dataset, or ``None`` when the instance was filtered/failed, plus its
  :class:`~repro_torch.core.manifest.ManifestEntry`. A warm replay decodes exactly
  what the cold path produced, so outputs are byte-identical by construction.
* **study records** — one per (study, ruleset, project): the ordered list of
  instance cache keys making up a completed study. The planner uses these to
  answer "is this accession fully warm?" without touching pixel data.

Pickle is the container (matching ``storage.object_store.StudyStore``); the
lake only ever sees the resulting bytes.
"""
from __future__ import annotations

import pickle
from typing import List, Optional, Tuple

from repro_torch.core.manifest import ManifestEntry
from repro_torch.dicom.dataset import DicomDataset

_INSTANCE_RECORD_V = 1
_STUDY_RECORD_V = 1


def encode_instance_record(
    dataset: Optional[DicomDataset], entry: ManifestEntry
) -> bytes:
    return pickle.dumps(
        ("inst", _INSTANCE_RECORD_V, dataset, entry.to_dict()),
        protocol=pickle.HIGHEST_PROTOCOL,
    )


def decode_instance_record(blob: bytes) -> Tuple[Optional[DicomDataset], ManifestEntry]:
    kind, version, dataset, entry_dict = pickle.loads(blob)
    if kind != "inst" or version != _INSTANCE_RECORD_V:
        raise ValueError(f"not an instance record: {kind!r} v{version}")
    return dataset, ManifestEntry.from_dict(entry_dict)


def encode_study_record(instance_keys: List[str]) -> bytes:
    return pickle.dumps(
        ("study", _STUDY_RECORD_V, list(instance_keys)),
        protocol=pickle.HIGHEST_PROTOCOL,
    )


def decode_study_record(blob: bytes) -> List[str]:
    kind, version, keys = pickle.loads(blob)
    if kind != "study" or version != _STUDY_RECORD_V:
        raise ValueError(f"not a study record: {kind!r} v{version}")
    return keys
