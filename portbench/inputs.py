"""Inputs the benchmark makes from ``--seed``: weights, token batches,
prompts, CT pixel stacks, DICOM tags and catalog rows.

Nothing here comes from the program: the generators are the benchmark's own
(a frozen copy of the arithmetic the port's generators use, where one
exists), so a change to the program cannot move the traffic. Every function
is deterministic in its seed; the same seed gives the same inputs on any
device.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def rng(seed: int, *key: object) -> np.random.Generator:
    """A numpy generator for one named stream of one seed."""
    h = hashlib.sha256("|".join(map(str, (int(seed) & SEED_MASK,) + key)).encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "big"))


def torch_generator(seed: int, key: str, device) -> torch.Generator:
    h = hashlib.sha256(f"{int(seed) & SEED_MASK}|{key}".encode()).digest()
    return torch.Generator(device).manual_seed(int.from_bytes(h[:8], "big") & SEED_MASK)


# ------------------------------------------------------------------ LM weights
def lm_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every leaf drawn from one normal draw on ``device`` (std 0.02; norm
    scales 1 + that), sliced in sorted-name order and cast to ``dtype``.
    ``shapes`` maps dotted parameter names to shapes."""
    names = sorted(shapes)
    total = sum(math.prod(shapes[n]) for n in names)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(0.0, 0.02, generator=torch_generator(seed, "weights", device))
    out, off = {}, 0
    for n in names:
        k = math.prod(shapes[n])
        w = flat[off:off + k].view(shapes[n])
        if n.rsplit(".", 1)[-1].startswith("ln"):
            w = w + 1.0
        out[n] = w.to(dtype)
        off += k
    del flat
    return out


def zipf_tokens(r: np.random.Generator, shape, vocab: int, a: float) -> np.ndarray:
    """Zipfian token ids (natural-language-like marginals), as the port's
    ``SyntheticTokenPipeline`` draws them."""
    z = r.zipf(a, size=shape)
    return np.minimum(z - 1, vocab - 1).astype(np.int32)


def stratified_lognormal(r: np.random.Generator, n: int, median: float, sigma: float, lo: int,
                         hi: int) -> np.ndarray:
    """``n`` lognormal lengths clipped to [lo, hi], one drawn in each of
    ``n`` equal-probability strata of the distribution (the point within
    each stratum from ``r``), in an order drawn from ``r``."""
    from statistics import NormalDist

    u = (np.arange(n) + r.random(n)) / n
    z = np.array([NormalDist().inv_cdf(float(min(max(p, 1e-12), 1 - 1e-12))) for p in u])
    lens = np.clip(np.round(median * np.exp(sigma * z)), lo, hi).astype(np.int64)
    return lens[r.permutation(n)]


def serve_requests(seed: int, batches: int, batch: int, prompt: dict, output: dict, vocab: int,
                   a: float) -> List[Tuple[List[int], int]]:
    """``batches`` batches of ``batch`` requests, each a (prompt token ids,
    tokens to generate) pair. Each batch draws its prompt lengths and its
    output lengths by ``stratified_lognormal`` (``prompt`` and ``output``
    give ``median``, ``sigma``, ``min`` and ``max``), so every batch holds
    lengths of its own from the same distribution; the token ids are Zipf."""
    r = rng(seed, "serve-requests")
    out = []
    for _ in range(batches):
        p = stratified_lognormal(r, batch, prompt["median"], prompt["sigma"], prompt["min"],
                                 prompt["max"])
        o = stratified_lognormal(r, batch, output["median"], output["sigma"], output["min"],
                                 output["max"])
        out.extend((zipf_tokens(r, (int(n),), vocab, a).tolist(), int(m)) for n, m in zip(p, o))
    return out


# ----------------------------------------------------------------- CT studies
def ct_pixel_stack(seed: int, key: str, n: int, rows: int, cols: int, maxval: int,
                   rects: Sequence[Sequence[int]], burn_every: int, device) -> np.ndarray:
    """(n, rows, cols) uint16 slices drawn on ``device``: a radial body plus
    16x16-block noise (the port generator's background arithmetic), with a
    burned-in text banner (vertical strokes) in ``rects`` on every
    ``burn_every``-th slice. Returned on the host."""
    g = torch_generator(seed, f"ct-stack|{key}", device)
    y = torch.linspace(-1, 1, rows, device=device)[:, None]
    x = torch.linspace(-1, 1, cols, device=device)[None, :]
    body = torch.clamp(1.0 - (x * x + y * y), 0, 1)
    out = np.empty((n, rows, cols), np.uint16)
    step = 64
    for s0 in range(0, n, step):
        m = min(step, n - s0)
        noise = torch.rand((m, -(-rows // 16), -(-cols // 16)), generator=g, device=device)
        noise = noise.repeat_interleave(16, 1).repeat_interleave(16, 2)[:, :rows, :cols]
        img = (0.55 * body + 0.25 * noise) * maxval * 0.6
        burn = torch.rand((m, rows, cols), generator=g, device=device) < 0.85
        img = img.to(torch.int32)
        for j in range(m):
            if (s0 + j) % burn_every:
                continue
            for rx, ry, rw, rh in rects:
                x2, y2 = min(rx + rw, cols), min(ry + rh, rows)
                region = img[j, ry:y2, rx:x2]
                strokes = ((torch.arange(x2 - rx, device=device) // 3) % 2 == 0)[None, :]
                mask = strokes & burn[j, ry:y2, rx:x2]
                region.copy_(torch.where(mask, torch.full_like(region, maxval),
                                         (region.float() * 0.1).to(torch.int32)))
        out[s0:s0 + m] = img.to(torch.int32).cpu().numpy().astype(np.uint16)
    return out


_FIRST = ["JANE", "JOHN", "MARIA", "WEI", "PRIYA", "OMAR", "SOFIA", "LIAM"]
_LAST = ["DOE", "SMITH", "GARCIA", "CHEN", "PATEL", "HASSAN", "ROSSI", "KIM"]
UID_ROOT = "1.2.840.99999.2.1"


def uid(entropy: str) -> str:
    h = int.from_bytes(hashlib.sha256(entropy.encode()).digest()[:8], "big")
    return f"{UID_ROOT}.{h}"


def ct_study_tags(seed: int, accession: str, date: int, device: dict, n: int) -> dict:
    """Per-study identity and per-instance tags of one CT study: the PHI an
    archive's CT carries (names, MRN, dates, UIDs, institution, free text,
    a private creator) beside the device's geometry."""
    r = rng(seed, "ct-tags", accession)
    mrn = f"{int(r.integers(10**7)):08d}"
    name = f"{_LAST[int(r.integers(len(_LAST)))]}^{_FIRST[int(r.integers(len(_FIRST)))]}"
    study_uid = uid(f"{seed}|study/{accession}")
    series_uid = uid(f"{seed}|series/{accession}/1")
    d = f"{date:08d}"
    common = {
        "SOPClassUID": "1.2.840.10008.5.1.4.1.1.2",
        "StudyInstanceUID": study_uid,
        "SeriesInstanceUID": series_uid,
        "StudyID": accession,
        "SeriesNumber": 1,
        "AccessionNumber": accession,
        "PatientName": name,
        "PatientID": mrn,
        "PatientBirthDate": "19600101",
        "PatientSex": "O",
        "PatientAge": "064Y",
        "ReferringPhysicianName": "REF^DOCTOR",
        "OperatorsName": "TECH^ONE",
        "InstitutionName": "STANFORD HOSPITAL",
        "InstitutionAddress": "300 Pasteur Dr, Palo Alto CA",
        "StudyDate": d, "SeriesDate": d, "AcquisitionDate": d, "ContentDate": d,
        "StudyTime": "081500", "SeriesTime": "081730",
        "Modality": device["modality"],
        "Manufacturer": device["manufacturer"],
        "ManufacturerModelName": device["model"],
        "BodyPartExamined": "CHEST",
        "DeviceSerialNumber": f"SN{int(r.integers(10**6)):06d}",
        "StationName": f"STA{int(r.integers(100)):02d}",
        "Rows": device["rows"], "Columns": device["cols"],
        "BitsAllocated": 16, "BitsStored": device["bits_stored"], "SamplesPerPixel": 1,
        "BurnedInAnnotation": "NO",
        "ImageType": "ORIGINAL\\PRIMARY\\AXIAL",
        "SeriesDescription": "CT series",
        "StudyDescription": f"CT study for MRN {mrn}",
        "PatientComments": f"Patient {name} seen by Dr. House",
    }
    instances = []
    for i in range(n):
        el = dict(common)
        el["SOPInstanceUID"] = uid(f"{seed}|{accession}/{series_uid}/{i}")
        el["InstanceNumber"] = i + 1
        instances.append(el)
    private = {"(0009,0010)": "VENDOR PRIVATE CREATOR", "(0009,1001)": f"internal-id-{mrn}"}
    return {"mrn": mrn, "name": name, "study_uid": study_uid, "date": d,
            "instances": instances, "private": private}


# ------------------------------------------------------------ catalog rows
_MODALITIES = ["CT", "MR", "DX", "US", "CR", "PT"]
_MAKES = ["GE Medical", "Siemens", "Philips", "Canon"]
_MODELS = ["Optima CT660", "MAGNETOM Aera", "Epiq 7", "DRX-1"]
_PARTS = ["CHEST", "HEAD", "ABDOMEN", "KNEE"]


def catalog_background(seed: int, accessions: int, per_accession: int) -> Dict[str, np.ndarray]:
    """A hospital archive's metadata rows, as the port's catalog benchmark
    builds them: six modalities, four makes and models, StudyDate in
    2016-2020 and sorted (sealed blocks carry tight zone maps). Returned as
    columns; string columns as indices into the lists above."""
    r = rng(seed, "catalog")
    n = accessions * per_accession
    dates = np.sort(20150000 + r.integers(1, 6, n) * 10000 + r.integers(1, 13, n) * 100
                    + r.integers(1, 29, n))
    return {
        "modality": r.integers(len(_MODALITIES), size=n),
        "body_part": r.integers(len(_PARTS), size=n),
        "manufacturer": r.integers(len(_MAKES), size=n),
        "model": r.integers(len(_MODELS), size=n),
        "study_date": dates,
        "bits_stored": r.choice([8, 12, 16], size=n),
        "nbytes": r.integers(10_000, 600_000, size=n),
        "burned_in": (r.random(n) < 0.1).astype(np.int64),
        "burned_in_detected": (r.random(n) < 0.08).astype(np.int64),
    }


def catalog_row_dicts(cols: Dict[str, np.ndarray], lo: int, hi: int) -> List[dict]:
    """Rows ``lo``..``hi`` of :func:`catalog_background` as the catalog's
    ingest takes them."""
    names = {"modality": _MODALITIES, "body_part": _PARTS, "manufacturer": _MAKES, "model": _MODELS}
    per = {}
    for c, v in cols.items():
        vals = v[lo:hi].tolist()
        per[c] = [names[c][i] for i in vals] if c in names else vals
    per["rows"] = [512] * (hi - lo)
    per["cols"] = [512] * (hi - lo)
    keys = list(per)
    return [dict(zip(keys, vals)) for vals in zip(*(per[k] for k in keys))]


def catalog_background_modality(i: int) -> str:
    return _MODALITIES[i]
