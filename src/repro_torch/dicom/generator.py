"""Deterministic synthetic DICOM study generator.

Stands in for the clinical PACS feed (no real PHI exists in this environment).
Reproduces the *statistical shape* of the paper's archive (Figure 1): study
mix dominated by diagnostic x-ray, image counts dominated by CT/MR (a CT study
has hundreds-to-thousands of slices); and the *adversarial content* the
pipeline must handle: burned-in PHI text at device-specific regions, PDFs, SR
documents, secondary captures, Vidar film scans, etc. (paper Discussion list).

Everything is seeded: the same (seed, accession) always yields bit-identical
studies, which the regression suite and exactly-once tests rely on.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.dicom.dataset import DicomDataset, new_uid
from repro_torch.dicom.devices import DeviceKey, FIXED_DEVICES, VIDAR_DEVICE, Rect, registry

# Figure 1 (paper): studies dominated by x-ray; images dominated by CT/MR.
MODALITY_STUDY_MIX = {"DX": 0.40, "CR": 0.12, "CT": 0.20, "MR": 0.13, "US": 0.10, "PT": 0.05}
IMAGES_PER_STUDY = {"CT": (80, 600), "MR": (60, 400), "PT": (100, 400), "US": (4, 40), "DX": (1, 4), "CR": (1, 3)}
_PIXEL_DTYPE = {"CT": np.uint16, "MR": np.uint16, "PT": np.uint16, "US": np.uint8, "DX": np.uint16, "CR": np.uint16}
_MAXVAL = {np.uint16: 4095, np.uint8: 255}

PROBLEM_KINDS = [
    "pdf", "sr", "presentation_state", "raw_modality", "secondary_capture",
    "burned_in_yes", "conversion_type_empty", "derived", "vidar", "video",
]

_FIRST = ["JANE", "JOHN", "MARIA", "WEI", "PRIYA", "OMAR", "SOFIA", "LIAM"]
_LAST = ["DOE", "SMITH", "GARCIA", "CHEN", "PATEL", "HASSAN", "ROSSI", "KIM"]

# BodyPartExamined mix per modality — gives the metadata catalog a realistic
# anatomical dimension to select cohorts on (no PHI content).
_BODY_PARTS = {
    "CT": ["CHEST", "ABDOMEN", "HEAD", "PELVIS"],
    "MR": ["BRAIN", "SPINE", "KNEE"],
    "PT": ["WHOLEBODY", "CHEST"],
    "US": ["ABDOMEN", "HEART", "THYROID"],
    "DX": ["CHEST", "HAND", "FOOT", "SPINE"],
    "CR": ["CHEST", "ANKLE"],
}


@dataclass
class SyntheticStudy:
    accession: str
    mrn: str
    patient_name: str
    study_uid: str
    study_date: str
    modality: str
    device: DeviceKey
    body_part: str = ""
    datasets: List[DicomDataset] = field(default_factory=list)
    # ground truth for tests: regions that contain burned-in PHI, per instance
    phi_rects: Dict[str, List[Rect]] = field(default_factory=dict)

    def nbytes(self) -> int:
        return sum(d.nbytes() for d in self.datasets)


class StudyGenerator:
    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.registry = registry()

    # ---------------------------------------------------------------- internals
    def _rng(self, *key: object) -> np.random.Generator:
        h = hashlib.sha256(("|".join(map(str, (self.seed,) + key))).encode()).digest()
        return np.random.default_rng(int.from_bytes(h[:8], "big"))

    def _pick_device(self, modality: str, rng: np.random.Generator) -> DeviceKey:
        if modality == "US":
            variants = self.registry.all_us_variants()
            return variants[int(rng.integers(len(variants)))]
        cands = [d for d in FIXED_DEVICES if d.modality == modality]
        return cands[int(rng.integers(len(cands)))]

    # resolutions novel (manufacturer, model) variants show up with — modest
    # sizes (sim corpora carry many of these), deliberately not tile-aligned
    # so the detector's padding path is exercised end to end
    _UNKNOWN_RES = {
        "CT": (320, 512), "MR": (288, 320), "PT": (320, 512),
        "DX": (520, 648), "CR": (520, 648),
    }

    def unknown_device(self, salt: str, modality: Optional[str] = None) -> DeviceKey:
        """A device variant *outside* the registry (novel manufacturer/model).

        The registry still synthesizes burn-in geometry for it (``scrub_rects``
        is hash-derived for any key), so :meth:`gen_study` burns PHI text into
        deterministic regions — but the scrub script has no rule for the
        variant, which is exactly the coverage gap the detector subsystem
        exists to close. US is excluded: unknown ultrasound is whitelist-
        rejected upstream, never detector-scrubbed (paper Table 2).
        """
        rng = self._rng("unknown-device", salt)
        if modality is None or modality == "US":
            mods = sorted(self._UNKNOWN_RES)
            modality = mods[int(rng.integers(len(mods)))]
        rows, cols = self._UNKNOWN_RES[modality]
        key = DeviceKey(
            modality,
            f"Novel{int(rng.integers(100)):02d}",
            f"NX-{int(rng.integers(1000)):03d}",
            rows,
            cols,
        )
        assert not self.registry.known(key), key
        return key

    def _background(self, rng: np.random.Generator, rows: int, cols: int, dtype) -> np.ndarray:
        """Cheap anatomy-ish background: radial falloff + low-freq noise."""
        maxv = _MAXVAL[dtype]
        y = np.linspace(-1, 1, rows, dtype=np.float32)[:, None]
        x = np.linspace(-1, 1, cols, dtype=np.float32)[None, :]
        body = np.clip(1.0 - (x * x + y * y), 0, 1)
        noise = rng.random((-(-rows // 16), -(-cols // 16)), dtype=np.float32)
        noise = np.kron(noise, np.ones((16, 16), np.float32))[:rows, :cols]
        img = (0.55 * body + 0.25 * noise) * maxv * 0.6
        return img.astype(dtype)

    def _burn_text(self, img: np.ndarray, rect: Rect, rng: np.random.Generator) -> None:
        """Burn a synthetic text banner: high-contrast glyph-like strokes."""
        x, y, w, h = rect
        H, W = img.shape[:2]
        x2, y2 = min(x + w, W), min(y + h, H)
        if x >= x2 or y >= y2:
            return
        maxv = _MAXVAL[img.dtype.type]
        region = img[y:y2, x:x2]
        # vertical stroke pattern with glyph-ish gaps: strong horiz gradients
        strokes = (np.arange(region.shape[1]) // 3) % 2 == 0
        mask = np.broadcast_to(strokes, region.shape).copy()
        mask &= rng.random(region.shape) < 0.85
        region[mask] = maxv
        region[~mask] = (region[~mask] * 0.1).astype(img.dtype)

    # ---------------------------------------------------------------- instances
    def _make_instance(
        self,
        study: SyntheticStudy,
        series_uid: str,
        idx: int,
        device: DeviceKey,
        burn_rects: List[Rect],
        rng: np.random.Generator,
    ) -> DicomDataset:
        dtype = _PIXEL_DTYPE[device.modality]
        ds = DicomDataset()
        ds["SOPClassUID"] = f"1.2.840.10008.5.1.4.1.1.{ {'CT':'2','MR':'4','US':'6.1','PT':'128','DX':'1.1','CR':'1'}[device.modality] }"
        ds["SOPInstanceUID"] = new_uid(f"{study.accession}/{series_uid}/{idx}")
        ds["StudyInstanceUID"] = study.study_uid
        ds["SeriesInstanceUID"] = series_uid
        ds["StudyID"] = study.accession
        ds["SeriesNumber"] = 1
        ds["InstanceNumber"] = idx + 1
        ds["AccessionNumber"] = study.accession
        ds["PatientName"] = study.patient_name
        ds["PatientID"] = study.mrn
        ds["PatientBirthDate"] = "19600101"
        ds["PatientSex"] = "O"
        ds["PatientAge"] = "064Y"
        ds["ReferringPhysicianName"] = "REF^DOCTOR"
        ds["OperatorsName"] = "TECH^ONE"
        ds["InstitutionName"] = "STANFORD HOSPITAL"
        ds["InstitutionAddress"] = "300 Pasteur Dr, Palo Alto CA"
        ds["StudyDate"] = study.study_date
        ds["SeriesDate"] = study.study_date
        ds["AcquisitionDate"] = study.study_date
        ds["ContentDate"] = study.study_date
        ds["StudyTime"] = "081500"
        ds["SeriesTime"] = "081730"
        ds["Modality"] = device.modality
        ds["Manufacturer"] = device.make
        ds["ManufacturerModelName"] = device.model
        if study.body_part:
            ds["BodyPartExamined"] = study.body_part
        ds["DeviceSerialNumber"] = f"SN{int(rng.integers(1e6)):06d}"
        ds["StationName"] = f"STA{int(rng.integers(100)):02d}"
        ds["Rows"] = device.rows
        ds["Columns"] = device.cols
        ds["BitsAllocated"] = 16 if dtype == np.uint16 else 8
        # stored sample depth: 12-bit data in 16-bit words, full range for u8
        ds["BitsStored"] = 12 if dtype == np.uint16 else 8
        ds["SamplesPerPixel"] = 1
        ds["BurnedInAnnotation"] = "NO"
        ds["ImageType"] = "ORIGINAL\\PRIMARY\\AXIAL"
        ds["SeriesDescription"] = f"{device.modality} series"
        ds["StudyDescription"] = f"{device.modality} study for MRN {study.mrn}"  # PHI leak vector
        ds["PatientComments"] = f"Patient {study.patient_name} seen by Dr. House"  # PHI leak vector
        ds.private["(0009,0010)"] = "VENDOR PRIVATE CREATOR"
        ds.private["(0009,1001)"] = f"internal-id-{study.mrn}"

        img = self._background(rng, device.rows, device.cols, dtype)
        for rect in burn_rects:
            self._burn_text(img, rect, rng)
        ds.pixels = img
        if burn_rects:
            study.phi_rects[ds["SOPInstanceUID"]] = list(burn_rects)
        return ds

    # ---------------------------------------------------------------- studies
    def gen_study(
        self,
        accession: str,
        modality: Optional[str] = None,
        n_images: Optional[int] = None,
        device: Optional[DeviceKey] = None,
        problem: Optional[str] = None,
    ) -> SyntheticStudy:
        """Generate one study. ``problem`` injects a paper-Discussion pathology."""
        rng = self._rng("study", accession)
        if modality is None:
            mods, probs = zip(*MODALITY_STUDY_MIX.items())
            modality = str(rng.choice(mods, p=np.array(probs) / sum(probs)))
        if device is None:
            device = VIDAR_DEVICE if problem == "vidar" else self._pick_device(modality, rng)
        modality = device.modality
        if n_images is None:
            lo, hi = IMAGES_PER_STUDY[modality]
            n_images = int(rng.integers(lo, hi + 1))

        mrn = f"{int(rng.integers(1e7)):08d}"
        name = f"{_LAST[int(rng.integers(len(_LAST)))]}^{_FIRST[int(rng.integers(len(_FIRST)))]}"
        y, m, d = 2015 + int(rng.integers(5)), 1 + int(rng.integers(12)), 1 + int(rng.integers(28))
        parts = _BODY_PARTS.get(modality, ["CHEST"])
        study = SyntheticStudy(
            accession=accession,
            mrn=mrn,
            patient_name=name,
            study_uid=new_uid(f"study/{accession}"),
            study_date=f"{y:04d}{m:02d}{d:02d}",
            modality=modality,
            device=device,
            body_part=parts[int(rng.integers(len(parts)))],
        )
        series_uid = new_uid(f"series/{accession}/1")
        burn_rects = self.registry.scrub_rects(device)
        # CT/MR: only a subset of slices carry the burned-in banner (dose screens)
        for i in range(n_images):
            inst_rng = self._rng("inst", accession, i)
            if modality in ("CT", "MR", "PT"):
                rects = burn_rects if (i % 17 == 0) else []
            else:
                rects = burn_rects
            study.datasets.append(self._make_instance(study, series_uid, i, device, rects, inst_rng))

        if problem:
            study.datasets.append(self._make_problem_instance(study, series_uid, problem, rng))
        return study

    def _make_problem_instance(
        self, study: SyntheticStudy, series_uid: str, kind: str, rng: np.random.Generator
    ) -> DicomDataset:
        """Instances the filter stage must reject (paper Discussion items 1-3)."""
        assert kind in PROBLEM_KINDS, kind
        ds = self._make_instance(study, series_uid, 9999, study.device, [], rng)
        if kind == "pdf":
            ds["SOPClassUID"] = "1.2.840.10008.5.1.4.1.1.104.1"  # Encapsulated PDF
            ds.encapsulated = b"%PDF-1.4 synthetic report for " + study.patient_name.encode()
            ds.pixels = None
        elif kind == "sr":
            ds["SOPClassUID"] = "1.2.840.10008.5.1.4.1.1.88.11"  # Basic Text SR
            ds["Modality"] = "SR"
            ds.pixels = None
        elif kind == "presentation_state":
            ds["SOPClassUID"] = "1.2.840.10008.5.1.4.1.1.11.1"  # GSPS
            ds["Modality"] = "PR"
            ds.pixels = None
        elif kind == "raw_modality":
            ds["Modality"] = "RAW"
        elif kind == "secondary_capture":
            ds["SOPClassUID"] = "1.2.840.10008.5.1.4.1.1.7"  # Secondary Capture
            ds["ImageType"] = "DERIVED\\SECONDARY"
        elif kind == "burned_in_yes":
            ds["BurnedInAnnotation"] = "YES"
        elif kind == "conversion_type_empty":
            ds["ConversionType"] = ""
        elif kind == "derived":
            ds["ImageType"] = "DERIVED\\PRIMARY\\REFORMATTED"
        elif kind == "vidar":
            ds["Manufacturer"] = "Vidar"
            ds["ConversionType"] = "DF"  # digitized film
        elif kind == "video":
            ds["SOPClassUID"] = "1.2.840.10008.5.1.4.1.1.77.1.4.1"  # Video Photographic
            ds["ConversionType"] = "SI"
        return ds

    # ---------------------------------------------------------------- batches
    def gen_request(self, accessions: List[str], modality: Optional[str] = None, **kw) -> List[SyntheticStudy]:
        return [self.gen_study(a, modality=modality, **kw) for a in accessions]
