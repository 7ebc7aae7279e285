"""Anonymizer stage: remove/replace metadata known to contain PHI.

Third stage of the paper's engine. Executes the parsed anonymizer script
against a dataset: explicit per-tag rules first (first rule naming a tag
wins, CTP semantics), then the ``default`` policy sweeps every remaining tag.
Private groups and free-text VRs have dedicated sweep actions because they
are the highest-risk leak vectors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.pseudonym import PseudonymService
from repro_torch.core.rules import AnonRule, parse_anonymizer_script, render_template, script_sha
from repro_torch.dicom.dataset import DicomDataset, new_uid
from repro_torch.dicom.tags import FREETEXT_KEYWORDS, TAGS


@dataclass
class AnonResult:
    dataset: DicomDataset
    tag_actions: Dict[str, str] = field(default_factory=dict)


class AnonymizerStage:
    def __init__(self, script_text: str) -> None:
        self.script_text = script_text
        self.rules = parse_anonymizer_script(script_text)
        self.sha = script_sha(script_text)
        self._explicit: Dict[str, AnonRule] = {}
        self._default = "remove"
        self._sweep_private = False
        self._sweep_freetext = False
        for r in self.rules:
            if r.action == "default":
                self._default = r.template
            elif r.action == "removeprivate":
                self._sweep_private = True
            elif r.action == "removefreetext":
                self._sweep_freetext = True
            elif r.keyword is not None and r.keyword not in self._explicit:
                self._explicit[r.keyword] = r

    def __call__(
        self,
        ds: DicomDataset,
        params: Dict[str, str],
        pseudo: Optional[PseudonymService] = None,
    ) -> AnonResult:
        out = ds.copy()
        actions: Dict[str, str] = {}
        jitter = int(params.get("jitter", 0))

        for kw in list(out.keys()):
            rule = self._explicit.get(kw)
            if rule is None:
                continue
            if rule.action == "keep":
                actions[kw] = "keep"
            elif rule.action == "remove":
                out.pop(kw)
                actions[kw] = "remove"
            elif rule.action == "empty":
                out[kw] = ""
                actions[kw] = "empty"
            elif rule.action == "set":
                out[kw] = render_template(rule.template, params, ds)
                actions[kw] = "set"
            elif rule.action == "hashuid":
                # UID remapped through the study-scoped pseudonym key so
                # references stay consistent *within* a request but cannot be
                # joined across research studies.
                salt = params.get("uid_salt", "")
                out[kw] = new_uid(f"{salt}|{ds.get(kw, '')}")
                actions[kw] = "hashuid"
            elif rule.action == "jitterdate":
                out[kw] = PseudonymService.jitter_date(str(ds.get(kw, "")), jitter)
                actions[kw] = "jitterdate"

        # sweeps
        if self._sweep_private and out.private:
            for tag in list(out.private):
                del out.private[tag]
            actions["<private>"] = "removeprivate"
        if self._sweep_freetext:
            for kw in FREETEXT_KEYWORDS:
                if kw in out and actions.get(kw) != "keep":
                    out.pop(kw)
                    actions[kw] = "removefreetext"
        # default policy over remaining known tags
        for kw in list(out.keys()):
            if kw in actions or kw == "PixelData":
                continue
            if self._default == "remove":
                out.pop(kw)
                actions[kw] = "default-remove"
            else:
                actions[kw] = "default-keep"
        return AnonResult(out, actions)
