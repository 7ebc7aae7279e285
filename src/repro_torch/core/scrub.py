"""Scrub stage: blank PHI pixel regions and recompress (paper Figure 2a).

Looks up the device variant's scrub rectangles in the site scrub script,
blanks them ("replaced by black pixels"), and recompresses with the
JPEG-Lossless-style codec. The blanking compute itself is pluggable:

* ``numpy_blank`` — host reference path (single instance);
* ``repro_torch.kernels.scrub.ops.make_blank_fn`` — the CUDA scrub kernel
  behind the same single-instance protocol.

The burned-in-PHI detector is not ported yet: a stage built with an enabled
``DetectorPolicy`` raises ``NotImplementedError``. A disabled policy (mode
"off") behaves as no policy, as in the JAX package.

Defense in depth: an ultrasound instance with no scrub rule should have been
filtered upstream; the stage re-checks and fails closed rather than passing
un-scrubbed US pixels through.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.audit.ledger import NULL_LEDGER
from repro_torch.core.rules import parse_scrub_script, script_sha
from repro_torch.detect.policy import DetectorPolicy
from repro_torch.detect.report import DetectionReport, DetectStats
from repro_torch.dicom import codec
from repro_torch.dicom.dataset import DicomDataset
from repro_torch.dicom.devices import DeviceKey, Rect, registry


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
        # the registry-only behavior, the only one ported so far
        if policy is not None and policy.enabled:
            raise NotImplementedError("detector not ported yet")
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

    def _resolve_rects(
        self, ds: DicomDataset
    ) -> Tuple[Tuple[Rect, ...], Optional[DetectionReport]]:
        """Rects to blank for this instance (the detection report slot stays
        None until the detector is ported); raises :class:`ScrubError` on the
        fail-closed cases shared by the serial and batched paths.
        """
        if ds.pixels is None:
            raise ScrubError("no pixel data to scrub (object should have been filtered)")
        rects = self.rects_for(ds)
        registry_hit = rects is not None
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
        return tuple(rects or ()), None

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
        batch_idx: List[int] = []
        items: List[Tuple[np.ndarray, List[Rect]]] = []
        for i, ds in enumerate(datasets):
            try:
                rects, detection = self._resolve_rects(ds)
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
