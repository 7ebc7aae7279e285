"""Deterministic cache keys for the de-identified result lake (DESIGN.md §6).

A cached de-id result is only reusable when three things are unchanged:

* the **instance content** — any pixel or metadata edit must recompute;
* the **ruleset** — filter/anonymizer/scrubber scripts *and* the device
  registry's scrub geometry (the scrub script is generated from the registry,
  but the filter's ultrasound whitelist builtin also consults the registry
  directly, so geometry is fingerprinted on its own);
* the **project pseudonym salt** — the same instance de-identified for two
  research studies yields different pseudonyms/UIDs by design, so results are
  never shared across projects.

The cache key is a digest over exactly those three, which makes invalidation
structural: editing one scrub rule changes the ruleset fingerprint and
thereby invalidates *every* entry minted under it, and nothing else.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Iterable, Optional

from repro_torch.dicom.devices import DeviceRegistry, FIXED_DEVICES, registry

if TYPE_CHECKING:  # pragma: no cover - type-only, avoids a core<->lake cycle
    from repro_torch.core.pipeline import DeidRequest
    from repro_torch.dicom.dataset import DicomDataset


def _sha(*parts: str) -> str:
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def callable_identity(fn) -> str:
    """Stable, behavior-sensitive identity for a pipeline callable (e.g. the
    scrub stage's ``blank_fn``). Name alone is not enough — two same-named
    lambdas with different bodies must not share cache keys — so the bytecode
    and constants are folded in when available; ``functools.partial`` recurses
    on the wrapped function (its ``repr`` embeds a memory address, which would
    never hit across processes)."""
    import functools

    if isinstance(fn, functools.partial):
        return (
            f"partial({callable_identity(fn.func)},args={fn.args!r},"
            f"kw={sorted((fn.keywords or {}).items())!r})"
        )
    ident = f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', type(fn).__name__)}"
    code = getattr(fn, "__code__", None)
    if code is not None:
        body = hashlib.sha256(code.co_code + repr(code.co_consts).encode()).hexdigest()
        ident += f"#{body[:12]}"
    return ident


def geometry_digest(reg: Optional[DeviceRegistry] = None) -> str:
    """Digest of the device registry's scrub geometry and US whitelist.

    Any change to a device's blanking rectangles — or to whitelist
    membership, which the filter stage consults — must invalidate cached
    results computed under the old geometry.
    """
    reg = reg or registry()
    lines = []
    for key in sorted(reg.all_us_variants(), key=lambda k: k.id()):
        lines.append(f"{key.id()}:{reg.scrub_rects(key)}")
    for key in FIXED_DEVICES:
        lines.append(f"{key.id()}:{reg.scrub_rects(key)}")
    return _sha(*lines)


@dataclass(frozen=True)
class RulesetFingerprint:
    """Versioned identity of the full rule surface a result was computed under.

    ``config_sha`` digests the pipeline settings that shape delivered bytes
    beyond the scripts themselves (recompress, codec selection value, blank
    function) — two pipelines differing only in those must not share keys.
    ``detector_sha`` digests the burned-in pixel-PHI detector surface
    (detector version + :class:`repro_torch.detect.DetectorPolicy` knobs): a
    policy edit or a new detector changes which pixels get blanked, so
    results minted under the old behavior must never be served warm. The
    empty string is the no-detector (pre-§9) identity.
    """

    filter_sha: str
    anonymizer_sha: str
    scrubber_sha: str
    geometry_sha: str
    config_sha: str = ""
    detector_sha: str = ""

    @property
    def digest(self) -> str:
        return _sha(
            "ruleset",
            self.filter_sha,
            self.anonymizer_sha,
            self.scrubber_sha,
            self.geometry_sha,
            self.config_sha,
            self.detector_sha,
        )

    @classmethod
    def of(
        cls,
        script_shas: Dict[str, str],
        reg: Optional[DeviceRegistry] = None,
        config: str = "",
        detector: str = "",
    ) -> "RulesetFingerprint":
        """Build from a pipeline's ``script_shas`` + the live device registry."""
        return cls(
            filter_sha=script_shas["filter"],
            anonymizer_sha=script_shas["anonymizer"],
            scrubber_sha=script_shas["scrubber"],
            geometry_sha=geometry_digest(reg),
            config_sha=_sha("config", config),
            detector_sha=_sha("detector", detector) if detector else "",
        )


def instance_digest(ds: "DicomDataset") -> str:
    """Content digest of one SOP instance: metadata, private tags, pixels,
    and encapsulated payload. Canonicalized (sorted keys) so element insertion
    order does not leak into the key."""
    h = hashlib.sha256()
    h.update(
        json.dumps(
            {k: str(v) for k, v in ds.elements.items()}, sort_keys=True
        ).encode()
    )
    h.update(
        json.dumps({k: str(v) for k, v in ds.private.items()}, sort_keys=True).encode()
    )
    if ds.pixels is not None:
        h.update(str((ds.pixels.dtype.name, ds.pixels.shape)).encode())
        h.update(ds.pixels.tobytes())
    if ds.encapsulated is not None:
        h.update(ds.encapsulated)
    return h.hexdigest()


def request_salt(request: "DeidRequest") -> str:
    """Project pseudonym salt: digests everything the anonymizer consumes from
    the request (anon accession/MRN, jitter, uid salt) plus the research study
    and trust mode. Deterministic per (research study, accession), different
    across research studies — cached results never cross project boundaries."""
    params = request.script_params()
    return _sha(
        "salt",
        request.research_study,
        request.mode,
        *(f"{k}={params[k]}" for k in sorted(params)),
    )


def cache_key(inst_digest: str, ruleset_digest: str, salt: str) -> str:
    """Content-addressed key for one instance's de-id result."""
    return _sha("inst", inst_digest, ruleset_digest, salt)


def study_key(accession: str, source_etag: str, ruleset_digest: str, salt: str) -> str:
    """Key for a study-level completion record. ``source_etag`` is the data
    lake's content etag for the identified study, so the planner can test
    warmth without reading (or hashing) a single pixel."""
    return _sha("study", accession, source_etag, ruleset_digest, salt)
