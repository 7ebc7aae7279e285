"""Carry studies and model weights across from plain Python and numpy values.

The de-identification system has no weights: its state is the study (tags,
private tags, pixels) and the script texts, which are the same strings in
every implementation. :func:`study_to_plain` reads any object with the
``SyntheticStudy``/``DicomDataset`` attribute names into dicts, tuples and
numpy arrays, and :func:`study_from_plain` builds this package's objects
from them, so a study made elsewhere can be de-identified here.

The LM stack's weights cross as a nested dict of numpy arrays
(:func:`model_params_from_numpy`), keyed as the model's parameter tree, and
a whole training state (weights, AdamW moments and master copy, compression
residuals) as any tree of that shape (:func:`train_state_from_numpy`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.dicom.dataset import DicomDataset
from repro_torch.dicom.devices import DeviceKey
from repro_torch.dicom.generator import SyntheticStudy
from repro_torch.models.spec import tree_items
from repro_torch.training.checkpoint import flatten_with_paths, unflatten_with_paths


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


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """numpy (bfloat16 by its dtype name, as ml_dtypes spells it) -> tensor."""
    arr = np.array(arr, copy=True)  # writable, contiguous, owned by the tensor
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def model_params_from_numpy(model, tree: Dict[str, Any]) -> None:
    """Load a nested dict of numpy arrays into ``model``'s parameters (in
    place, on the model's device). Every dotted path, shape and dtype must
    match the model's: a missing, extra or mismatched leaf raises
    ``ValueError`` and nothing is loaded."""
    params = dict(model.named_parameters())
    given = dict(tree_items(tree))
    if set(params) != set(given):
        raise ValueError(f"parameter paths differ: missing {sorted(set(params) - set(given))}, "
                         f"unknown {sorted(set(given) - set(params))}")
    loaded = {}
    for path, param in params.items():
        arr = np.asarray(given[path])
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)} != {tuple(param.shape)}")
        if arr.dtype.name != str(param.dtype).removeprefix("torch."):
            raise ValueError(f"{path}: dtype {arr.dtype.name} != {param.dtype}")
        loaded[path] = _tensor_from_numpy(arr)
    with torch.no_grad():
        for path, param in params.items():
            param.copy_(loaded[path])


def train_state_from_numpy(state, tree):
    """Load a training state held as numpy leaves (``tree``: anything with
    the ``TrainState`` layout, ``params``, ``opt.step/m/v/master`` and
    ``comp`` residuals, NamedTuples and dicts as the JAX package builds it)
    into ``state``, the port's ``TrainState``. The model's parameters are
    written in place; the returned state holds new tensors for the rest, on
    the device of the leaf they replace. Every key, shape and dtype must
    match ``state``'s: a missing, extra or mismatched leaf raises
    ``ValueError`` and nothing is loaded."""
    have = flatten_with_paths(state)
    given = flatten_with_paths(tree)
    if set(have) != set(given):
        raise ValueError(f"state leaves differ: missing {sorted(set(have) - set(given))}, "
                         f"unknown {sorted(set(given) - set(have))}")
    loaded = {}
    for key, leaf in have.items():
        arr = np.asarray(given[key])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != {tuple(leaf.shape)}")
        if arr.dtype.name != str(leaf.dtype).removeprefix("torch."):
            raise ValueError(f"{key}: dtype {arr.dtype.name} != {leaf.dtype}")
        loaded[key] = _tensor_from_numpy(arr).to(leaf.device)
    with torch.no_grad():
        for key, leaf in have.items():
            if isinstance(leaf, torch.nn.Parameter):
                leaf.copy_(loaded[key])
                loaded[key] = leaf
    return unflatten_with_paths(state, loaded)
