"""Cucumber-style regression scenarios (paper Figure 2b).

The paper's regression suite is human-readable Gherkin executed against the
pipeline ("If any of these tests fail, the regression test results in
failure"). This module reproduces that contract: a small Gherkin-subset
parser + runner whose steps match the paper's wording:

    Given the pipeline uses the anonymizer script, "<name>"
    Given the pipeline uses the pixel script, "<name>"
    Given the pipeline uses the filter script, "<name>"
    And script parameter "<key>" is "<value>"
    Scenario: <title>
      Given the DICOM directory "<virtual path>"
      When ran through the deid pipeline
      Then the images SHOULD be anonymized
      Then the images SHOULD NOT pass the filter
      Then the resulting images should be scrubbed at x,y,w,h

Virtual DICOM directories are resolved against the seeded generator:
  dicom-phi/<MOD>/Anonymize              clean study of that modality
  dicom-phi/<MOD>/Filter                 problem objects (paper Discussion)
  dicom-phi/<MOD>/Scrub/<Make>/<Model>/<RxC>   one instance of that device

:func:`run_feature` runs on ``device`` (default ``cuda:0``; pass
``device="cpu"`` for the plain PyTorch versions): each instance's rects
are blanked by the scrub kernel (``kernels/scrub/ops.py::make_blank_fn``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.manifest import Outcome
from repro_torch.core.pipeline import DeidPipeline, DeidRequest
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dicom.dataset import DicomDataset
from repro_torch.dicom.devices import DeviceKey
from repro_torch.dicom.generator import PROBLEM_KINDS, StudyGenerator
from repro_torch.kernels.scrub.ops import make_blank_fn


@dataclass
class Scenario:
    title: str
    directory: str = ""
    expectations: List[Tuple[str, object]] = field(default_factory=list)


@dataclass
class Feature:
    title: str
    params: Dict[str, str] = field(default_factory=dict)
    scripts: Dict[str, str] = field(default_factory=dict)
    scenarios: List[Scenario] = field(default_factory=list)


_RECT_RE = re.compile(r"scrubbed at\s+(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)")


class FeatureParseError(ValueError):
    """A feature file the runner cannot execute. Carries the 1-based line
    number and offending text so the regression-suite author sees exactly
    which step is malformed (the paper's suite is written by humans)."""

    def __init__(self, lineno: int, line: str, why: str) -> None:
        super().__init__(f"line {lineno}: {why}: {line!r}")
        self.lineno = lineno
        self.line = line
        self.why = why


def parse_feature(text: str) -> Feature:
    feature = Feature("")
    scenario: Optional[Scenario] = None
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        low = line.lower()
        if low.startswith("feature:"):
            feature.title = line.split(":", 1)[1].strip()
        elif low.startswith("background:"):
            scenario = None
        elif low.startswith("scenario:"):
            scenario = Scenario(line.split(":", 1)[1].strip())
            feature.scenarios.append(scenario)
        elif "uses the" in low and "script" in low:
            m = re.search(r'uses the (\w+) script,?\s+"([^"]+)"', line)
            if not m:
                raise FeatureParseError(
                    lineno, raw, 'bad script step (want: uses the <kind> script, "<name>")'
                )
            feature.scripts[m.group(1)] = m.group(2)
        elif low.startswith(("and script parameter", "given script parameter")):
            m = re.search(r'parameter\s+"([^"]+)"\s+is\s+"([^"]+)"', line)
            if not m:
                raise FeatureParseError(
                    lineno, raw, 'bad parameter step (want: parameter "<key>" is "<value>")'
                )
            feature.params[m.group(1)] = m.group(2)
        elif "the dicom directory" in low:
            m = re.search(r'"([^"]+)"', line)
            if m is None:
                raise FeatureParseError(lineno, raw, "directory step without a quoted path")
            if scenario is None:
                raise FeatureParseError(
                    lineno, raw, "Given directory outside any Scenario block"
                )
            scenario.directory = m.group(1)
        elif low.startswith("when"):
            continue  # single action: ran through the pipeline
        elif low.startswith("then") or low.startswith("and the resulting"):
            if scenario is None:
                raise FeatureParseError(lineno, raw, "Then step outside any Scenario block")
            if "should not pass the filter" in low:
                scenario.expectations.append(("filtered", True))
            elif "should be anonymized" in low:
                scenario.expectations.append(("anonymized", True))
            elif "jittered" in low:
                scenario.expectations.append(("jittered", True))
            elif "scrubbed at" in low:
                m = _RECT_RE.search(line)
                if m is None:
                    raise FeatureParseError(
                        lineno, raw, "bad scrub expectation (want: scrubbed at x,y,w,h)"
                    )
                scenario.expectations.append(("scrub_rect", tuple(int(g) for g in m.groups())))
            else:
                raise FeatureParseError(lineno, raw, "unknown Then step")
    return feature


class VirtualDicomTree:
    """Resolves the feature files' virtual directories to generated datasets."""

    def __init__(self, seed: int = 99) -> None:
        self.gen = StudyGenerator(seed)

    def resolve(self, path: str) -> List[DicomDataset]:
        parts = path.strip("/").split("/")
        assert parts[0] == "dicom-phi", path
        modality = parts[1]
        kind = parts[2]
        if kind == "Anonymize":
            return self.gen.gen_study(f"SCN-{modality}-anon", modality=modality, n_images=3).datasets
        if kind == "Filter":
            # dicom-phi/<MOD>/Filter            -> the classic six problem objects
            # dicom-phi/<MOD>/Filter/<problem>  -> one specific PROBLEM_KINDS entry
            if len(parts) > 3:
                p = parts[3]
                if p not in PROBLEM_KINDS:
                    raise KeyError(f"unknown problem kind {p!r} in {path!r}")
                kinds = [p]
            else:
                kinds = PROBLEM_KINDS[:6]
            out = []
            for p in kinds:
                s = self.gen.gen_study(f"SCN-{modality}-{p}", modality=modality, n_images=0, problem=p)
                out.append(s.datasets[-1])
            return out
        if kind == "Scrub":
            make, model, res = parts[3], parts[4], parts[5]
            rows, cols = (int(x) for x in res.split("x"))
            dev = DeviceKey(modality, make.replace("_", " "), model.replace("_", " "), rows, cols)
            return self.gen.gen_study(f"SCN-{dev.id()}", device=dev, n_images=1).datasets
        raise KeyError(path)


@dataclass
class ScenarioResult:
    scenario: str
    passed: bool
    detail: str = ""


def run_feature(
    feature: Feature,
    tree: Optional[VirtualDicomTree] = None,
    device: DeviceLike = None,
) -> List[ScenarioResult]:
    tree = tree or VirtualDicomTree()
    dev = resolve_device(device)
    # scripts "default" -> site scripts; rects blanked by the scrub kernel
    pipeline = DeidPipeline(recompress=False, blank_fn=make_blank_fn(dev), device=dev)
    request = DeidRequest(
        research_study="SCENARIO",
        accession="SRC",
        anon_accession=feature.params.get("accession", "ACN123"),
        anon_mrn=feature.params.get("mrn", "MRN123"),
        jitter=int(feature.params.get("jitter", "-6")),
    )
    results: List[ScenarioResult] = []
    for scn in feature.scenarios:
        datasets = tree.resolve(scn.directory)
        outputs = [pipeline.process_instance(ds, request) for ds in datasets]
        ok, detail = True, ""
        for kind, arg in scn.expectations:
            if kind == "filtered":
                bad = [e for _, e in outputs if e.outcome is not Outcome.FILTERED]
                if bad:
                    ok, detail = False, f"{len(bad)} instances passed the filter"
            elif kind == "anonymized":
                for out, e in outputs:
                    if e.outcome is not Outcome.ANONYMIZED:
                        ok, detail = False, f"outcome {e.outcome}"
                    elif out.get("AccessionNumber") != request.anon_accession:
                        ok, detail = False, "accession not replaced"
                    elif out.get("PatientID") != request.anon_mrn:
                        ok, detail = False, "mrn not replaced"
            elif kind == "jittered":
                for out, e in outputs:
                    if e.outcome is Outcome.ANONYMIZED and "StudyDate" in out:
                        src = [d for d in datasets if d.get("SOPClassUID")]
                        if out["StudyDate"] == src[0].get("StudyDate"):
                            ok, detail = False, "date not jittered"
            elif kind == "scrub_rect":
                x, y, w, h = arg
                for out, e in outputs:
                    if out is None:
                        ok, detail = False, "instance filtered, expected scrub"
                        continue
                    region = out.pixels[y : y + h, x : x + w]
                    if region.size and region.max() != 0:
                        ok, detail = False, f"region {arg} not blank"
        results.append(ScenarioResult(scn.title, ok, detail))
    return results
