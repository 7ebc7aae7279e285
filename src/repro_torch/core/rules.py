"""CTP-style rule scripts: filter, anonymizer, and scrubber DSLs.

The paper extracts MIRC CTP's DICOM *filtering* and *anonymizing* components
and drives them with site-maintained scripts (stanford-filter.script,
stanford-anonymizer.script, stanford-scrubber.script). We reproduce that
contract: rules live in human-readable text scripts, are parsed once into
rule objects, and are executed by the pipeline stages. Scripts are versioned
artifacts — their SHA goes into every manifest entry, which is what makes
on-demand re-de-identification reproducible (the paper's core requirement
that vendor black-box APIs could not meet).

Grammar (one rule per line, ``#`` comments):

Filter script::

    reject <Keyword> <op> ["value"] [unless <exemption>]
    accept <Keyword> <op> ["value"]          # short-circuit accept
    reject builtin:<predicate> [unless <exemption>]

  ops: equals | notequals | contains | startswith | in | empty | exists | missing
  builtins: us_not_whitelisted (device-registry lookup), video_sop_class

Anonymizer script::

    set <Keyword> <template>    # @param(name) and @hash(Keyword) substitution
    empty <Keyword>
    remove <Keyword>
    keep <Keyword>
    hashuid <Keyword>
    jitterdate <Keyword>
    removeprivate
    removefreetext
    default keep|remove

Scrubber script::

    scrub <Modality> <Make> <Model> <RowsxCols> (x,y,w,h) [(x,y,w,h) ...]
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.dicom.dataset import DicomDataset
from repro_torch.dicom.devices import DeviceKey, Rect, registry

# --------------------------------------------------------------------- filter
# equals/notequals/in are implemented via DicomDataset.matches (shared CS
# normalization — case/whitespace-insensitive, the same the catalog uses at
# ingest) inside FilterRule.matches, so they have no entry here. startswith
# stays byte-exact — it is used for UID prefixes, which are never CS.
_MATCHES_OPS = frozenset({"equals", "notequals", "in"})
_FILTER_OPS: Dict[str, Callable[[str, str], bool]] = {
    "contains": lambda v, arg: arg.upper() in v.upper(),
    "startswith": lambda v, arg: v.startswith(arg),
    "empty": lambda v, arg: v == "",
    "exists": lambda v, arg: True,  # presence checked separately
    "missing": lambda v, arg: False,
}


def _builtin_us_not_whitelisted(ds: DicomDataset) -> bool:
    if ds.get("Modality") != "US":
        return False
    res = ds.resolution()
    if res is None:
        return True
    key = DeviceKey("US", str(ds.get("Manufacturer", "")), str(ds.get("ManufacturerModelName", "")), *res)
    return not registry().us_whitelisted(key)


def _builtin_video_sop_class(ds: DicomDataset) -> bool:
    return str(ds.get("SOPClassUID", "")).startswith("1.2.840.10008.5.1.4.1.1.77.1.4")


BUILTIN_PREDICATES: Dict[str, Callable[[DicomDataset], bool]] = {
    "us_not_whitelisted": _builtin_us_not_whitelisted,
    "video_sop_class": _builtin_video_sop_class,
}

# Exemptions: the paper marks some reject categories "may be bypassed by
# specific whitelisting rules based on other attributes".
EXEMPTIONS: Dict[str, Callable[[DicomDataset], bool]] = {
    # e.g. derived CT localizers are safe: no burned-in demographics
    "derived_localizer": lambda ds: ds.image_type_contains("LOCALIZER")
    and ds.get("Modality") in ("CT", "MR"),
    # secondary captures from a known-safe converter station
    "trusted_sc_station": lambda ds: str(ds.get("StationName", "")).startswith("SAFE"),
}


@dataclass(frozen=True)
class FilterRule:
    action: str  # "reject" | "accept"
    keyword: Optional[str]  # None for builtin rules
    op: Optional[str]
    arg: str = ""
    builtin: Optional[str] = None
    unless: Optional[str] = None
    line: str = ""

    def matches(self, ds: DicomDataset) -> bool:
        if self.builtin is not None:
            hit = BUILTIN_PREDICATES[self.builtin](ds)
        else:
            present = self.keyword in ds
            if self.op == "exists":
                hit = present
            elif self.op == "missing":
                hit = not present
            elif not present:
                hit = False
            elif self.op == "equals":
                hit = ds.matches(self.keyword, self.arg)
            elif self.op == "notequals":
                hit = not ds.matches(self.keyword, self.arg)
            elif self.op == "in":
                hit = any(ds.matches(self.keyword, a) for a in self.arg.split(","))
            else:
                hit = _FILTER_OPS[self.op](str(ds.get(self.keyword, "")), self.arg)
        if hit and self.unless and EXEMPTIONS[self.unless](ds):
            return False
        return hit


_FILTER_RE = re.compile(
    r"^(reject|accept)\s+(?:builtin:(\w+)|(\w+)\s+(\w+)(?:\s+\"([^\"]*)\")?)"
    r"(?:\s+unless\s+(\w+))?$"
)


def parse_filter_script(text: str) -> List[FilterRule]:
    rules: List[FilterRule] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        m = _FILTER_RE.match(line)
        if not m:
            raise ValueError(f"bad filter rule: {raw!r}")
        action, builtin, kw, op, arg, unless = m.groups()
        if builtin is not None:
            if builtin not in BUILTIN_PREDICATES:
                raise ValueError(f"unknown builtin {builtin!r}")
            rules.append(FilterRule(action, None, None, "", builtin, unless, line))
        else:
            if op not in _FILTER_OPS and op not in _MATCHES_OPS:
                raise ValueError(f"unknown op {op!r} in {raw!r}")
            if unless and unless not in EXEMPTIONS:
                raise ValueError(f"unknown exemption {unless!r}")
            rules.append(FilterRule(action, kw, op, arg or "", None, unless, line))
    return rules


# ----------------------------------------------------------------- anonymizer
@dataclass(frozen=True)
class AnonRule:
    action: str  # set/empty/remove/keep/hashuid/jitterdate/removeprivate/removefreetext/default
    keyword: Optional[str] = None
    template: str = ""
    line: str = ""


_TEMPLATE_RE = re.compile(r"@(param|hash)\(([^)]+)\)")


def render_template(template: str, params: Dict[str, str], ds: DicomDataset) -> str:
    def sub(m: re.Match) -> str:
        kind, name = m.group(1), m.group(2).strip()
        if kind == "param":
            if name not in params:
                raise KeyError(f"missing script parameter {name!r}")
            return str(params[name])
        # @hash(Keyword): stable one-way digest of the original value
        return hashlib.sha256(str(ds.get(name, "")).encode()).hexdigest()[:16]

    return _TEMPLATE_RE.sub(sub, template)


def parse_anonymizer_script(text: str) -> List[AnonRule]:
    rules: List[AnonRule] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split(None, 2)
        action = parts[0]
        if action in ("removeprivate", "removefreetext"):
            rules.append(AnonRule(action, line=line))
        elif action == "default":
            if len(parts) != 2 or parts[1] not in ("keep", "remove"):
                raise ValueError(f"bad default rule: {raw!r}")
            rules.append(AnonRule("default", template=parts[1], line=line))
        elif action in ("set",):
            if len(parts) != 3:
                raise ValueError(f"bad set rule: {raw!r}")
            rules.append(AnonRule(action, parts[1], parts[2], line=line))
        elif action in ("empty", "remove", "keep", "hashuid", "jitterdate"):
            if len(parts) != 2:
                raise ValueError(f"bad {action} rule: {raw!r}")
            rules.append(AnonRule(action, parts[1], line=line))
        else:
            raise ValueError(f"unknown anonymizer action {action!r} in {raw!r}")
    return rules


# -------------------------------------------------------------------- scrubber
@dataclass(frozen=True)
class ScrubRule:
    key: Tuple[str, str, str, int, int]  # modality, make, model, rows, cols
    rects: Tuple[Rect, ...]


_SCRUB_RE = re.compile(
    r"^scrub\s+(\S+)\s+(\S+)\s+(\S+)\s+(\d+)x(\d+)\s+((?:\(\s*\d+\s*,\s*\d+\s*,\s*\d+\s*,\s*\d+\s*\)\s*)+)$"
)
_RECT_RE = re.compile(r"\(\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\)")


def parse_scrub_script(text: str) -> Dict[Tuple[str, str, str, int, int], Tuple[Rect, ...]]:
    out: Dict[Tuple[str, str, str, int, int], Tuple[Rect, ...]] = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        m = _SCRUB_RE.match(line)
        if not m:
            raise ValueError(f"bad scrub rule: {raw!r}")
        mod, make, model, rows, cols, rects_s = m.groups()
        rects = tuple(
            (int(a), int(b), int(c), int(d)) for a, b, c, d in _RECT_RE.findall(rects_s)
        )
        # makes with spaces are encoded with underscores in scripts
        out[(mod, make.replace("_", " "), model.replace("_", " "), int(rows), int(cols))] = rects
    return out


def emit_scrub_script(header: str = "") -> str:
    """Generate the site scrub script from the device registry (DESIGN.md §3:
    generator and rules share the device ground truth, mirroring the paper's
    per-device rule derivation)."""
    reg = registry()
    lines = [f"# {header}" if header else "# auto-generated site scrubber script"]
    keys: List[DeviceKey] = list(reg.all_us_variants())
    from repro_torch.dicom.devices import FIXED_DEVICES

    keys += [d for d in FIXED_DEVICES if d.make != "UnknownMake"]
    for key in keys:
        rects = reg.scrub_rects(key)
        if not rects:
            continue
        rect_s = " ".join(f"({x},{y},{w},{h})" for x, y, w, h in rects)
        lines.append(
            f"scrub {key.modality} {key.make.replace(' ', '_')} "
            f"{key.model.replace(' ', '_')} {key.rows}x{key.cols} {rect_s}"
        )
    return "\n".join(lines) + "\n"


def script_sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:12]
