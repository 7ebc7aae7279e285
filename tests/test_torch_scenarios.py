"""The port's Figure 2b regression suite (``repro_torch.core.scenarios``)
against the JAX package's: the same feature files give the same
per-scenario results, parse errors name the same line and reason, and
every problem kind is filtered. The port runs on ``device="cpu"``, where
each instance is blanked by the scrub kernel's plain version."""
from pathlib import Path

import pytest
import torch

import repro.core.scenarios as ref
from repro.dicom.generator import PROBLEM_KINDS
from repro_torch.core.scenarios import (
    FeatureParseError,
    VirtualDicomTree,
    parse_feature,
    run_feature,
)

FEATURES = sorted((Path(__file__).parent / "features").glob("*.feature"))


def _results(results):
    return [(r.scenario, r.passed, r.detail) for r in results]


def _both(text):
    port = run_feature(parse_feature(text), VirtualDicomTree(), device="cpu")
    jax = ref.run_feature(ref.parse_feature(text), ref.VirtualDicomTree())
    return port, jax


@pytest.mark.parametrize("path", FEATURES, ids=[p.stem for p in FEATURES])
def test_feature_file_equals_reference(path):
    port, jax = _both(path.read_text())
    assert port, f"{path} parsed no scenarios"
    assert _results(port) == _results(jax)
    failures = [r for r in port if not r.passed]
    assert not failures, "; ".join(f"{r.scenario}: {r.detail}" for r in failures)


def test_parser_matches_paper_grammar():
    text = (Path(__file__).parent / "features" / "pet_ct.feature").read_text()
    f = parse_feature(text)
    assert f.params["jitter"] == "-6"
    assert f.scripts["anonymizer"] == "stanford-anonymizer.script"
    assert len(f.scenarios) == 3
    rects = [e[1] for e in f.scenarios[1].expectations if e[0] == "scrub_rect"]
    assert rects == [(256, 0, 256, 22), (300, 22, 212, 80), (10, 478, 100, 10)]
    jf = ref.parse_feature(text)
    assert (f.title, f.params, f.scripts) == (jf.title, jf.params, jf.scripts)
    assert [(s.title, s.directory, s.expectations) for s in f.scenarios] == [
        (s.title, s.directory, s.expectations) for s in jf.scenarios
    ]


def test_failing_scenario_reports():
    bad = """
Feature: failure propagation
Scenario: wrong region expected blank
  Given the DICOM directory "dicom-phi/CT/Anonymize"
  When ran through the deid pipeline
  Then the resulting images should be scrubbed at 400,400,50,50
"""
    port, jax = _both(bad)
    assert not port[0].passed
    assert _results(port) == _results(jax)


_MALFORMED = {
    "bad_script_step": ('Feature: f\nGiven the pipeline uses the filter script missing-quotes',
                        2, "script step"),
    "bad_parameter_step": ("Feature: f\nAnd script parameter jitter is -6", 2, "parameter step"),
    "directory_without_quotes": ("Feature: f\nScenario: s\n  Given the DICOM directory dicom-phi/CT",
                                 3, "quoted path"),
    "directory_outside_scenario": ('Feature: f\nGiven the DICOM directory "dicom-phi/CT/Anonymize"',
                                   2, "outside any Scenario"),
    "then_outside_scenario": ("Feature: f\nThen the images should be anonymized", 2,
                              "outside any Scenario"),
    "malformed_scrub_rect": (
        'Feature: f\nScenario: s\n  Given the DICOM directory "dicom-phi/CT/Anonymize"\n'
        "  Then the resulting images should be scrubbed at 10,20,30", 4, "scrub expectation"),
    "unknown_then_step": (
        'Feature: f\nScenario: s\n  Given the DICOM directory "dicom-phi/CT/Anonymize"\n'
        "  Then the images should be deleted forever", 4, "unknown Then step"),
}


class TestMalformedFeatures:
    """A suite author's typo surfaces as the same parse error in both
    packages: line number, reason and offending text."""

    @pytest.mark.parametrize("case", sorted(_MALFORMED))
    def test_parse_error_equals_reference(self, case):
        text, lineno, why = _MALFORMED[case]
        with pytest.raises(FeatureParseError) as port:
            parse_feature(text)
        with pytest.raises(ref.FeatureParseError) as jax:
            ref.parse_feature(text)
        err = port.value
        assert err.lineno == lineno and why in err.why
        assert (err.lineno, err.line, err.why, str(err)) == (
            jax.value.lineno, jax.value.line, jax.value.why, str(jax.value))

    def test_error_message_carries_context(self):
        with pytest.raises(FeatureParseError) as ei:
            parse_feature("Feature: f\nThen the images should be anonymized")
        assert "line 2" in str(ei.value) and "anonymized" in str(ei.value)


@pytest.mark.parametrize("problem", PROBLEM_KINDS)
def test_every_problem_kind_is_filtered(problem):
    text = f"""
Feature: categorical exclusions ({problem})
Scenario: {problem} objects never reach the researcher
  Given the DICOM directory "dicom-phi/CT/Filter/{problem}"
  When ran through the deid pipeline
  Then the images should not pass the filter
"""
    port, jax = _both(text)
    assert port[0].passed, port[0].detail
    assert _results(port) == _results(jax)


def test_filter_directory_rejects_unknown_kind():
    with pytest.raises(KeyError):
        VirtualDicomTree().resolve("dicom-phi/CT/Filter/not_a_problem")


def test_scrub_directory_resolves_to_the_same_instances():
    """The virtual tree draws from the port's generator: the same seeded
    instance as the JAX tree's, pixel for pixel."""
    import numpy as np

    path = "dicom-phi/PT/Scrub/GE/Discovery/512x512"
    port, jax = VirtualDicomTree().resolve(path), ref.VirtualDicomTree().resolve(path)
    assert len(port) == len(jax) == 1
    assert np.array_equal(port[0].pixels, jax[0].pixels)
    assert dict(port[0].elements) == dict(jax[0].elements)


def test_default_device_is_the_card_without_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feature = parse_feature(FEATURES[0].read_text())
    with pytest.raises(RuntimeError, match="CUDA"):
        run_feature(feature)
