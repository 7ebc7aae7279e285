"""Scrub stage: blank PHI pixel regions and recompress (paper Figure 2a).

Looks up the device variant's scrub rectangles in the site scrub script,
blanks them ("replaced by black pixels"), and recompresses with the
JPEG-Lossless-style codec. The blanking compute itself is pluggable:

* ``numpy_blank`` — host reference path (single instance);
* ``repro_torch.kernels.scrub.ops.make_blank_fn`` — the CUDA scrub kernel
  behind the same single-instance protocol.

Under an enabled ``DetectorPolicy`` the burned-in-PHI detector proposes
rects for the instances the policy scans (registry misses under
``registry_first``, every instance under ``union``); they are merged with
the registry rects. ``scrub_study`` runs the detector's profile pass as one
batched executor dispatch per shape bucket (the textdetect kernel on the
card); the serial path runs the numpy oracle per instance, bit-identically.

Defense in depth: an ultrasound instance with no scrub rule should have been
filtered upstream; the stage re-checks and fails closed rather than passing
un-scrubbed US pixels through.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.audit.ledger import NULL_LEDGER
from repro_torch.audit.records import DETECTOR_DECISION
from repro_torch.core.rules import parse_scrub_script, script_sha
from repro_torch.detect.policy import DetectorPolicy
from repro_torch.detect.regions import detect_bands_for, merge_rects, policy_thresh
from repro_torch.detect.report import DetectionReport, DetectStats
from repro_torch.dicom import codec
from repro_torch.dicom.dataset import DicomDataset
from repro_torch.dicom.devices import DeviceKey, Rect, registry
from repro_torch.kernels.phi_detect.ops import stored_max_value


def numpy_blank(pixels: np.ndarray, rects: Sequence[Rect]) -> np.ndarray:
    """Reference blanking: set each (x, y, w, h) region to 0.

    Slice ends clamp to 0 so a rect lying entirely above/left of the frame
    (y + h <= 0 or x + w <= 0) is a no-op — a raw ``min(H, y + h)`` would go
    negative and wrap around to blank nearly the whole frame.
    """
    out = pixels.copy()
    H, W = out.shape[:2]
    for x, y, w, h in rects:
        out[max(0, y) : max(0, min(H, y + h)), max(0, x) : max(0, min(W, x + w))] = 0
    return out


class ScrubError(RuntimeError):
    pass


@dataclass
class ScrubResult:
    dataset: DicomDataset
    rects: List[Rect] = field(default_factory=list)
    recompressed: bool = False
    compressed_bytes: int = 0
    detection: Optional[DetectionReport] = None


class ScrubStage:
    def __init__(
        self,
        script_text: str,
        blank_fn: Callable[[np.ndarray, Sequence[Rect]], np.ndarray] = numpy_blank,
        recompress: bool = True,
        sv: int = 1,
        policy: Optional[DetectorPolicy] = None,
        registry=None,
        ledger=None,
    ) -> None:
        self.script_text = script_text
        self.rules = parse_scrub_script(script_text)
        self.sha = script_sha(script_text)
        self.blank_fn = blank_fn
        self.recompress = recompress
        self.sv = sv
        # burned-in pixel-PHI detector policy; None and mode="off" are both
        # the legacy registry-only behavior
        self.policy = policy
        self.ledger = ledger if ledger is not None else NULL_LEDGER
        # registry: optional shared MetricsRegistry so fleet-level snapshots
        # see repro_detect_* totals across every pipeline
        self.detect_stats = DetectStats(registry)

    def rects_for(self, ds: DicomDataset) -> Optional[Tuple[Rect, ...]]:
        res = ds.resolution()
        if res is None:
            return None
        key = (
            str(ds.get("Modality", "")),
            str(ds.get("Manufacturer", "")),
            str(ds.get("ManufacturerModelName", "")),
            res[0],
            res[1],
        )
        return self.rules.get(key)

    # ---------------------------------------------------------- rect resolution
    def _device_key(self, ds: DicomDataset) -> DeviceKey:
        res = ds.resolution() or (0, 0)
        return DeviceKey(
            str(ds.get("Modality", "")),
            str(ds.get("Manufacturer", "")),
            str(ds.get("ManufacturerModelName", "")),
            int(res[0]),
            int(res[1]),
        )

    def _detect_thresh(self, ds: DicomDataset) -> float:
        """Binarization threshold for this instance (shared derivation —
        the batched pre-pass buckets executor dispatches by it)."""
        return policy_thresh(ds, self.policy)

    def _wants_detection(self, ds: DicomDataset, registry_hit: bool) -> bool:
        """Batched pre-pass predicate: will :meth:`_resolve_rects` scan this
        instance's pixels? (US misses fail closed before detection; only
        single-plane 2D frames are scannable.)"""
        if self.policy is None or not self.policy.enabled:
            return False
        if ds.pixels is None or ds.pixels.ndim != 2:
            return False
        if not registry_hit and ds.get("Modality") == "US":
            return False
        return self.policy.wants_detection(registry_hit)

    def _resolve_rects(
        self, ds: DicomDataset, row_hits: Optional[np.ndarray] = None
    ) -> Tuple[Tuple[Rect, ...], Optional[DetectionReport]]:
        """Rects to blank for this instance (+ the detection audit report when
        a policy is active); raises :class:`ScrubError` on the fail-closed
        cases shared by the serial and batched paths.

        ``row_hits`` is the precomputed per-row glyph-hit profile from a
        batched executor dispatch — bit-identical to the host oracle computed
        here when absent, so serial and batched paths stay byte-identical.
        """
        if ds.pixels is None:
            raise ScrubError("no pixel data to scrub (object should have been filtered)")
        rects = self.rects_for(ds)
        registry_hit = rects is not None
        policy = self.policy
        if policy is not None and policy.enabled:
            self.detect_stats.instances += 1
            if registry_hit:
                self.detect_stats.registry_hits += 1
        if not registry_hit:
            # an unknown (manufacturer, model) is counted and surfaced as a
            # worker/fleet metric in every mode — detector on, off, or absent
            # — a coverage gap must never pass through silently
            self.detect_stats.unknown_lookups += 1
            registry().note_unknown(self._device_key(ds))
        if not registry_hit and ds.get("Modality") == "US":
            # fail closed: whitelist miss must never pass pixels through —
            # the detector complements the US whitelist, it never bypasses it
            raise ScrubError(
                f"no scrub rule for ultrasound variant "
                f"{ds.get('Manufacturer')}/{ds.get('ManufacturerModelName')}/"
                f"{ds.resolution()} — filter should have rejected it"
            )
        if policy is None or not policy.enabled:
            return tuple(rects or ()), None

        report = DetectionReport(
            sop_uid=str(ds.get("SOPInstanceUID", "")),
            modality=str(ds.get("Modality", "")),
            device=self._device_key(ds).id(),
            registry_hit=registry_hit,
            registry_rects=list(rects or ()),
            tau=policy.tau_for(str(ds.get("Modality", ""))),
        )
        combined: List[Rect] = list(rects or ())
        if self._wants_detection(ds, registry_hit):
            report.ceiling = stored_max_value(ds)
            report.thresh = report.ceiling * policy.binarize_frac
            report.detector_ran = True
            self.detect_stats.detector_runs += 1
            bands, drects = detect_bands_for(
                ds, policy, row_hits=row_hits, thresh=report.thresh
            )
            report.bands = bands
            report.detector_rects = drects
            if bands:
                self.detect_stats.detected += 1
                self.detect_stats.bands += len(bands)
            combined.extend(drects)
            # each detector run is a PHI decision: which pixels get blanked,
            # under which versioned policy — auditable per instance
            self.ledger.append(
                DETECTOR_DECISION,
                modality=report.modality,
                device=report.device,
                registry_hit=registry_hit,
                detected=bool(bands),
                bands=len(bands),
                detector_sha=policy.digest,
            )
        # registry + detector unions routinely overlap: normalize so the
        # fused kernel never double-blanks a tile (blanked set unchanged)
        applied = merge_rects(combined)
        report.applied_rects = list(applied)
        return tuple(applied), report

    def __call__(self, ds: DicomDataset) -> ScrubResult:
        rects, detection = self._resolve_rects(ds)
        return self._scrub_resolved(ds, rects, detection)

    def _scrub_resolved(
        self, ds: DicomDataset, rects: Tuple[Rect, ...], detection: Optional[DetectionReport]
    ) -> ScrubResult:
        """Blank + recompress with rects already resolved (shared by the
        serial path and the batched path's per-instance fallback, so rect
        resolution — and its detector scan/stats — runs exactly once)."""
        out = ds.copy()
        result = ScrubResult(out, list(rects), detection=detection)
        if rects:
            out.pixels = np.asarray(self.blank_fn(out.pixels, rects))
        if self.recompress and out.pixels is not None:
            # "recompressed using the JPEG Lossless syntax"
            compressed = codec.encode(out.pixels, self.sv)
            result.recompressed = True
            result.compressed_bytes = len(compressed)
            out["TransferSyntaxUID"] = "1.2.840.10008.1.2.4.70"
        return result

    # ------------------------------------------------------------- batched
    def scrub_study(
        self, datasets: Sequence[DicomDataset], executor
    ) -> List[Tuple[Optional[ScrubResult], Optional[ScrubError]]]:
        """Batched equivalent of calling the stage once per instance.

        Instances the executor supports are bucketed and run through the fused
        scrub+JLS kernel (``repro_torch.core.batch.BatchedDeidExecutor``); the rest
        (multi-sample frames, exotic dtypes, non-rectangle ``blank_fn``) take
        the per-instance oracle path. Per-instance errors stay per-instance:
        the result list is aligned with ``datasets`` and each slot holds
        either a :class:`ScrubResult` or the :class:`ScrubError` it raised.
        """
        slots: List[Tuple[Optional[ScrubResult], Optional[ScrubError]]] = [
            (None, None)
        ] * len(datasets)
        # custom blank_fns batch only if they declare rectangle-zero semantics
        rect_semantics = getattr(
            self.blank_fn, "rect_blank_semantics", self.blank_fn is numpy_blank
        )
        # detection pre-pass: instances the policy will scan ride the
        # shape-bucketed executor in batched kernel dispatches; their per-row
        # hit profiles are handed to _resolve_rects (bit-identical to the
        # host oracle it would otherwise run per instance)
        hits_for: Dict[int, np.ndarray] = {}
        if executor is not None and self.policy is not None and self.policy.enabled:
            scan_idx: List[int] = []
            scan_items: List[Tuple[np.ndarray, float]] = []
            for i, ds in enumerate(datasets):
                if self._wants_detection(ds, self.rects_for(ds) is not None):
                    scan_idx.append(i)
                    scan_items.append((ds.pixels, self._detect_thresh(ds)))
            if scan_items:
                profiles = executor.detect_row_hits(scan_items, tile=self.policy.tile)
                hits_for = dict(zip(scan_idx, profiles))
        batch_idx: List[int] = []
        items: List[Tuple[np.ndarray, List[Rect]]] = []
        for i, ds in enumerate(datasets):
            try:
                rects, detection = self._resolve_rects(ds, row_hits=hits_for.get(i))
            except ScrubError as e:
                slots[i] = (None, e)
                continue
            batchable = (
                executor is not None
                and rect_semantics
                and executor.supports(ds.pixels, self.recompress)
                # nothing to batch: no blanking and no recompression work
                and (rects or self.recompress)
            )
            if batchable:
                out = ds.copy()
                slots[i] = (ScrubResult(out, list(rects), detection=detection), None)
                batch_idx.append(i)
                items.append((out.pixels, list(rects)))
            else:
                # rects (and any detector scan) are already resolved above;
                # re-resolving via self(ds) would double-run the detector
                try:
                    slots[i] = (self._scrub_resolved(ds, rects, detection), None)
                except ScrubError as e:  # e.g. a refusing custom blank_fn —
                    slots[i] = (None, e)  # same containment as the serial path

        if items:
            outputs = executor.run(items, sv=self.sv, recompress=self.recompress)
            for i, bo in zip(batch_idx, outputs):
                result = slots[i][0]
                assert result is not None
                result.dataset.pixels = bo.pixels
                if self.recompress:
                    result.recompressed = True
                    result.compressed_bytes = len(bo.payload or b"")
                    result.dataset["TransferSyntaxUID"] = "1.2.840.10008.1.2.4.70"
        return slots
