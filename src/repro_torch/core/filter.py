"""Filter stage: accept or discard an instance based on metadata rules.

First stage of the paper's three-stage engine (Figure 2a). A rejected image
never reaches the researcher; the manifest records which rule fired.

Value comparison contract: equals/notequals/in rules compare through
``DicomDataset.matches`` (CS normalization — case/whitespace-insensitive),
the same normalization the metadata catalog applies at ingest, so a study
selected by a catalog query is judged by the filter under identical string
semantics. ``startswith`` stays byte-exact (UID prefixes are not CS).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.rules import FilterRule, parse_filter_script, script_sha
from repro_torch.dicom.dataset import DicomDataset


@dataclass
class FilterDecision:
    accepted: bool
    rule: Optional[str] = None  # rule line that decided (None = default accept)


class FilterStage:
    def __init__(self, script_text: str) -> None:
        self.script_text = script_text
        self.rules: List[FilterRule] = parse_filter_script(script_text)
        self.sha = script_sha(script_text)

    def __call__(self, ds: DicomDataset) -> FilterDecision:
        for rule in self.rules:
            if rule.matches(ds):
                if rule.action == "accept":
                    return FilterDecision(True, rule.line)
                return FilterDecision(False, rule.line)
        return FilterDecision(True, None)

    def explain(self, ds: DicomDataset) -> List[Tuple[str, bool]]:
        """Per-rule trace, used by the scenario runner and rule debugging."""
        return [(r.line, r.matches(ds)) for r in self.rules]
