"""Device registry: makes, models, resolutions, and PHI burn-in geometry.

This is the single source of truth shared by (a) the synthetic study generator,
which burns PHI text into the regions a given device stamps, and (b) the scrub
rule scripts, which blank those regions. That mirrors the paper's methodology:
scrub rules are derived per (make, model, resolution) from observed device
behaviour (Figure 2a), and ultrasound is *whitelist-only* (Table 2) because its
burn-in layout varies per resolution even within one model.

Counts reproduce paper Table 2: 11 ultrasound makes, the listed model counts and
resolution-variation counts (e.g. GE: 35 models, 151 resolution variants).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

Rect = Tuple[int, int, int, int]  # x, y, w, h  (paper's Fig 2b convention)

# --- Table 2 (paper): ultrasound makes -> (model count, resolution variations) ---
ULTRASOUND_TABLE2: Dict[str, Tuple[int, int]] = {
    "GE": (35, 151),
    "Siemens": (13, 24),
    "Acuson": (2, 14),
    "Philips": (12, 22),
    "Toshiba": (13, 24),
    "SonoSite": (6, 7),
    "Zonare": (3, 4),
    "BK Medical": (3, 7),
    "Aloka": (7, 10),
    "SuperSonic Imaging": (1, 15),
    "Samsung": (8, 16),
}

_US_RESOLUTIONS: List[Tuple[int, int]] = [
    (480, 640), (600, 800), (768, 1024), (720, 960), (960, 1280),
    (576, 768), (480, 720), (540, 720), (768, 1280), (1080, 1920),
    (624, 832), (712, 952), (480, 800), (664, 888), (600, 1024),
]


def _h(s: str) -> int:
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


@dataclass(frozen=True)
class DeviceKey:
    modality: str
    make: str
    model: str
    rows: int
    cols: int

    def id(self) -> str:
        return f"{self.modality}/{self.make}/{self.model}/{self.rows}x{self.cols}"


def _synth_rects(key: DeviceKey, n: int) -> List[Rect]:
    """Deterministic pseudo-random burn-in rectangles for a device variant.

    Layouts imitate real devices: a top banner (patient name/MRN), a corner
    block (institution / tech initials), and optionally a bottom strip
    (measurements). Geometry is hash-derived so every (make, model, resolution)
    differs — the property the paper cites as making ultrasound hard.
    """
    rects: List[Rect] = []
    seed = _h(key.id())
    H, W = key.rows, key.cols
    # top banner, always present
    bh = 16 + (seed % 5) * 8
    rects.append((0, 0, W, min(bh, H // 4)))
    if n >= 2:  # corner block
        cw, ch = W // 4 + (seed >> 8) % 32, 24 + (seed >> 16) % 40
        side = (seed >> 24) % 2
        x = 0 if side else max(0, W - cw)
        y = min(H - ch - 1, bh + 4 + (seed >> 32) % 16)
        rects.append((x, y, min(cw, W), min(ch, H - y)))
    if n >= 3:  # bottom strip
        sh = 10 + (seed >> 40) % 14
        rects.append((0, max(0, H - sh), W, sh))
    return rects[:n]


def _variant_resolution(make: str, model: str, i: int) -> Tuple[int, int]:
    """Unique-per-(model, i) resolution: a base mode plus device-specific
    crop offsets in multiples of 8 (how real US consoles vary: same probe
    mode, different screen layout)."""
    base_r, base_c = _US_RESOLUTIONS[_h(f"{make}/{model}") % len(_US_RESOLUTIONS)]
    return base_r + 8 * (i % 40), base_c + 8 * (i // 40 * 3 + (_h(f"{model}/{i}") % 3))


def build_ultrasound_whitelist() -> Dict[str, List[DeviceKey]]:
    """Expand Table 2 counts into concrete device variants, per make.

    Resolution variants are distributed across models round-robin so the total
    per make matches the paper's 'Resolution variations' column exactly.
    """
    out: Dict[str, List[DeviceKey]] = {}
    for make, (n_models, n_res_vars) in ULTRASOUND_TABLE2.items():
        models = [f"{make.upper().replace(' ', '')}-U{i+1:02d}" for i in range(n_models)]
        # GE's flagship gets the long tail (paper: LOGIQE9 alone had 38 resolutions)
        if make == "GE":
            models[0] = "LOGIQE9"
        variants: List[DeviceKey] = []
        per_model_count: Dict[str, int] = {m: 0 for m in models}
        i = 0
        while len(variants) < n_res_vars:
            if make == "GE" and len(variants) < 38:
                model = models[0]
            else:
                model = models[i % n_models]
            rows, cols = _variant_resolution(make, model, per_model_count[model])
            per_model_count[model] += 1
            key = DeviceKey("US", make, model, rows, cols)
            if key not in variants:
                variants.append(key)
            i += 1
        out[make] = variants
    return out


# --- Non-US modalities: a small registry of representative devices -------------
FIXED_DEVICES: List[DeviceKey] = [
    DeviceKey("CT", "GE", "Discovery", 512, 512),       # paper Fig 2b PET/CT fusion
    DeviceKey("CT", "Siemens", "SOMATOM", 512, 512),
    DeviceKey("CT", "Toshiba", "Aquilion", 512, 512),
    DeviceKey("MR", "GE", "SIGNA", 256, 256),
    DeviceKey("MR", "Siemens", "Skyra", 320, 320),
    DeviceKey("PT", "GE", "Discovery", 512, 512),
    DeviceKey("DX", "Philips", "DigitalDiagnost", 2022, 2022),
    DeviceKey("DX", "GE", "Definium", 2500, 2048),
    DeviceKey("CR", "Fuji", "FCR", 1760, 2140),
    DeviceKey("US", "UnknownMake", "Mystery-1", 480, 640),  # NOT whitelisted -> filtered
]

# Vidar film digitizer: always filtered (paper Discussion item 1).
VIDAR_DEVICE = DeviceKey("DX", "Vidar", "FilmScanner", 2048, 2048)


class DeviceRegistry:
    """Resolves scrub geometry and whitelist membership for device variants."""

    def __init__(self) -> None:
        self.us_whitelist = build_ultrasound_whitelist()
        self._us_index: Dict[str, DeviceKey] = {}
        for make, variants in self.us_whitelist.items():
            for v in variants:
                self._us_index[v.id()] = v
        self._fixed: Dict[str, DeviceKey] = {d.id(): d for d in FIXED_DEVICES}
        # unknown (manufacturer, model) lookups: counted and surfaced as a
        # worker/fleet metric — an unknown device is a PHI-coverage gap the
        # detector must absorb, never a silent pass-through
        self.unknown_lookups: Dict[Tuple[str, str], int] = {}

    # -- membership ----------------------------------------------------------
    def known(self, key: DeviceKey) -> bool:
        """Is this (modality, make, model, resolution) variant registered?"""
        return key.id() in self._fixed or key.id() in self._us_index

    def note_unknown(self, key: DeviceKey) -> None:
        """Record an unknown-device lookup (scrub-script miss)."""
        mk = (key.make, key.model)
        self.unknown_lookups[mk] = self.unknown_lookups.get(mk, 0) + 1

    def unknown_lookup_total(self) -> int:
        return sum(self.unknown_lookups.values())

    # -- scrub geometry ------------------------------------------------------
    def scrub_rects(self, key: DeviceKey) -> List[Rect]:
        """Regions this device burns PHI into (and rules must blank)."""
        if key.modality == "US":
            return _synth_rects(key, 3)  # US: heaviest burn-in (paper Discussion)
        if key.modality in ("PT", "CT") and key.make == "GE" and key.model == "Discovery":
            # paper Fig 2b literal regions for the GE PET/CT fusion
            return [(256, 0, 256, 22), (300, 22, 212, 80), (10, 478, 100, 10)]
        if key.modality in ("DX", "CR"):
            return _synth_rects(key, 2)
        if key.modality in ("CT", "MR", "PT"):
            return _synth_rects(key, 1)  # occasional dose/info banner
        return []

    # -- whitelist -----------------------------------------------------------
    def us_whitelisted(self, key: DeviceKey) -> bool:
        return key.id() in self._us_index

    def all_us_variants(self) -> List[DeviceKey]:
        return list(self._us_index.values())

    def table2_stats(self) -> Dict[str, Tuple[int, int]]:
        """(models, resolution variations) per make — reproduces paper Table 2."""
        out = {}
        for make, variants in self.us_whitelist.items():
            out[make] = (len({v.model for v in variants}), len(variants))
        return out


_REGISTRY: DeviceRegistry | None = None


def registry() -> DeviceRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = DeviceRegistry()
    return _REGISTRY
