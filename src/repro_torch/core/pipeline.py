"""The de-identification pipeline: filter -> scrub -> anonymize (Figure 2a).

One :class:`DeidPipeline` instance is the unit each queue worker runs. It is
deliberately stateless across instances (all request state rides in the
:class:`DeidRequest`). Its batched executor runs on ``device`` (default
``cuda:0``; pass ``device="cpu"`` for the plain PyTorch versions). With a
result lake attached (``lake=``), :meth:`DeidPipeline.run_study` replays
cached instances and de-identifies only the cold remainder.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

from repro_torch.audit.ledger import NULL_LEDGER
from repro_torch.audit.records import DEID_EXECUTE
from repro_torch.core.anonymize import AnonymizerStage
from repro_torch.core.batch import BatchedDeidExecutor
from repro_torch.core.filter import FilterStage
from repro_torch.core.manifest import Manifest, ManifestEntry, Outcome
from repro_torch.core.pseudonym import PseudonymService, TrustMode
from repro_torch.core.scrub import ScrubError, ScrubStage
from repro_torch.core import scripts as default_scripts
from repro_torch.dicom.dataset import DicomDataset
from repro_torch.dicom.generator import SyntheticStudy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.trace import NULL_TRACER

if TYPE_CHECKING:  # type-only: repro_torch.lake imports stay lazy (no import cycle)
    from repro_torch.lake.fingerprint import RulesetFingerprint
    from repro_torch.lake.store import ResultLake


@dataclass
class DeidRequest:
    """One imaging study to de-identify under one research study's rules."""

    research_study: str        # IRB protocol / pre-IRB request id
    accession: str             # original imaging accession
    anon_accession: str
    anon_mrn: str
    jitter: int
    mode: str = TrustMode.POST_IRB.value

    def script_params(self) -> Dict[str, str]:
        return {
            "accession": self.anon_accession,
            "mrn": self.anon_mrn,
            "jitter": str(self.jitter),
            "uid_salt": f"{self.research_study}|{self.anon_accession}",
        }


def build_request(
    pseudo: PseudonymService, accession: str, mrn: str
) -> DeidRequest:
    """Central-server side: validate + mint pseudonyms for one accession
    (paper: 'a new anonymized accession number, patient MRN, and randomized
    date jitter specific to the specific research study are created')."""
    return DeidRequest(
        research_study=pseudo.study_id,
        accession=accession,
        anon_accession=pseudo.accession(accession),
        anon_mrn=pseudo.mrn(mrn),
        jitter=pseudo.jitter_for(mrn),
        mode=pseudo.mode.value,
    )


@dataclass
class StudyDeidResult:
    """Everything one study de-identification produced.

    ``instance_keys`` is aligned with the study's datasets and empty when no
    result lake is attached; ``cache_hits``/``cache_misses`` count per-instance
    lake lookups for this study only.
    """

    delivered: List[DicomDataset]
    manifest: Manifest
    instance_keys: List[str] = field(default_factory=list)
    cache_hits: int = 0
    cache_misses: int = 0


class DeidPipeline:
    def __init__(
        self,
        filter_script: Optional[str] = None,
        anonymizer_script: Optional[str] = None,
        scrub_script: Optional[str] = None,
        blank_fn=None,
        recompress: bool = True,
        batched: bool = True,
        lake: Optional["ResultLake"] = None,
        detector_policy=None,
        tracer=None,
        registry=None,
        ledger=None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.filter = FilterStage(filter_script or default_scripts.DEFAULT_FILTER_SCRIPT)
        self.anonymizer = AnonymizerStage(
            anonymizer_script or default_scripts.DEFAULT_ANONYMIZER_SCRIPT
        )
        scrub_kwargs = {} if blank_fn is None else {"blank_fn": blank_fn}
        self.scrub = ScrubStage(
            scrub_script or default_scripts.DEFAULT_SCRUB_SCRIPT,
            recompress=recompress,
            policy=detector_policy,
            registry=registry,
            ledger=ledger,
            **scrub_kwargs,
        )
        # deterministic tracing (repro_torch.obs): run_study opens per-study spans;
        # the executor emits per-dispatch kernel profiling spans under them
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # audit ledger (repro_torch.audit): one deid_execute record per run_study
        self.ledger = ledger if ledger is not None else NULL_LEDGER
        # shape-bucketed batch dispatch over each study's instances; the
        # per-instance loop survives as process_study_serial (fallback/oracle)
        self.executor: Optional[BatchedDeidExecutor] = (
            BatchedDeidExecutor(tracer=self.tracer, registry=registry, device=self.device)
            if batched else None
        )
        self.script_shas = {
            "filter": self.filter.sha,
            "anonymizer": self.anonymizer.sha,
            "scrubber": self.scrub.sha,
        }
        # optional content-addressed result cache; per-instance short-circuit
        # happens in run_study, workers write study records back
        self.lake = lake
        self._fingerprint: Optional["RulesetFingerprint"] = None

    def ruleset_fingerprint(self) -> "RulesetFingerprint":
        """Fingerprint of this pipeline's full rule surface (scripts + device
        scrub geometry + output-shaping config). Computed once: scripts and
        config are immutable per pipeline."""
        if self._fingerprint is None:
            from repro_torch.lake.fingerprint import RulesetFingerprint, callable_identity

            config = (
                f"recompress={self.scrub.recompress}|sv={self.scrub.sv}|"
                f"blank={callable_identity(self.scrub.blank_fn)}"
            )
            # detector version + policy knobs: editing either must force a
            # cold serve (DESIGN.md §9) — "" preserves pre-detector keys for
            # pipelines with no policy attached AND for mode="off" (whose
            # delivered bytes are byte-identical to the legacy path, tested)
            detector = (
                self.scrub.policy.fingerprint_identity
                if self.scrub.policy is not None
                else ""
            )
            self._fingerprint = RulesetFingerprint.of(
                self.script_shas, config=config, detector=detector
            )
        return self._fingerprint

    # ------------------------------------------------------------- instances
    def process_instance(
        self, ds: DicomDataset, request: DeidRequest, worker_id: str = ""
    ) -> Tuple[Optional[DicomDataset], ManifestEntry]:
        """Run one SOP instance through the three stages."""
        params = request.script_params()
        try:
            decision = self.filter(ds)
            if not decision.accepted:
                entry = ManifestEntry(
                    sop_uid_anon="",
                    outcome=Outcome.FILTERED,
                    modality=str(ds.get("Modality", "")),
                    filter_rule=decision.rule,
                    original_bytes=ds.nbytes(),
                    worker_id=worker_id,
                    script_shas=self.script_shas,
                )
                return None, entry

            scrubbed = self.scrub(ds)
            anon = self.anonymizer(scrubbed.dataset, params)
            entry = ManifestEntry(
                sop_uid_anon=str(anon.dataset.get("SOPInstanceUID", "")),
                outcome=Outcome.ANONYMIZED,
                modality=str(ds.get("Modality", "")),
                scrub_rects=list(scrubbed.rects),
                tag_actions=anon.tag_actions,
                recompressed=scrubbed.recompressed,
                compressed_bytes=scrubbed.compressed_bytes,
                original_bytes=ds.nbytes(),
                worker_id=worker_id,
                script_shas=self.script_shas,
            )
            return anon.dataset, entry
        except ScrubError as e:
            entry = ManifestEntry(
                sop_uid_anon="",
                outcome=Outcome.FAILED,
                modality=str(ds.get("Modality", "")),
                original_bytes=ds.nbytes(),
                error=str(e),
                worker_id=worker_id,
                script_shas=self.script_shas,
            )
            return None, entry

    # --------------------------------------------------------------- studies
    def _deid_datasets(
        self, datasets: Sequence[DicomDataset], request: DeidRequest, worker_id: str
    ) -> List[Tuple[Optional[DicomDataset], ManifestEntry]]:
        """Run the three stages over a list of instances, returning aligned
        (delivered-or-None, entry) pairs. Uses the shape-bucketed executor
        when attached; falls back to the per-instance path otherwise."""
        if self.executor is None:
            return [self.process_instance(ds, request, worker_id) for ds in datasets]
        params = request.script_params()
        pairs: List[Optional[Tuple[Optional[DicomDataset], ManifestEntry]]] = [
            None
        ] * len(datasets)
        accepted: List[Tuple[int, DicomDataset]] = []
        with self.tracer.stage("pipeline.filter", instances=len(datasets)):
            for i, ds in enumerate(datasets):
                decision = self.filter(ds)
                if decision.accepted:
                    accepted.append((i, ds))
                else:
                    entry = ManifestEntry(
                        sop_uid_anon="",
                        outcome=Outcome.FILTERED,
                        modality=str(ds.get("Modality", "")),
                        filter_rule=decision.rule,
                        original_bytes=ds.nbytes(),
                        worker_id=worker_id,
                        script_shas=self.script_shas,
                    )
                    pairs[i] = (None, entry)

        with self.tracer.stage("pipeline.scrub", instances=len(accepted)):
            slots = self.scrub.scrub_study([ds for _, ds in accepted], self.executor)
        with self.tracer.stage("pipeline.anonymize", instances=len(accepted)):
            for (i, ds), (scrubbed, err) in zip(accepted, slots):
                if err is None:
                    try:
                        anon = self.anonymizer(scrubbed.dataset, params)
                    except ScrubError as e:  # parity with process_instance's catch scope
                        err = e
                if err is not None:
                    entry = ManifestEntry(
                        sop_uid_anon="",
                        outcome=Outcome.FAILED,
                        modality=str(ds.get("Modality", "")),
                        original_bytes=ds.nbytes(),
                        error=str(err),
                        worker_id=worker_id,
                        script_shas=self.script_shas,
                    )
                    pairs[i] = (None, entry)
                    continue
                entry = ManifestEntry(
                    sop_uid_anon=str(anon.dataset.get("SOPInstanceUID", "")),
                    outcome=Outcome.ANONYMIZED,
                    modality=str(ds.get("Modality", "")),
                    scrub_rects=list(scrubbed.rects),
                    tag_actions=anon.tag_actions,
                    recompressed=scrubbed.recompressed,
                    compressed_bytes=scrubbed.compressed_bytes,
                    original_bytes=ds.nbytes(),
                    worker_id=worker_id,
                    script_shas=self.script_shas,
                )
                pairs[i] = (anon.dataset, entry)
        for p in pairs:  # loud, not silent: a dropped slot is a lost instance
            assert p is not None
        return pairs  # type: ignore[return-value]

    def run_study(
        self, study: SyntheticStudy, request: DeidRequest, worker_id: str = ""
    ) -> StudyDeidResult:
        """De-identify every instance of a study.

        With a result lake attached, each instance is first looked up by its
        content-addressed key — hits replay the cached result (byte-identical
        to the cold path) and only the cold remainder flows through
        filter/scrub/anonymize; fresh results are written back. Without a
        lake this is the plain batched path.
        """
        manifest = Manifest(request_id=f"{request.research_study}/{request.anon_accession}")
        with self.tracer.span(
            "pipeline.run_study",
            accession=request.accession,
            instances=len(study.datasets),
        ) as _study_span:
            result = self._run_study_traced(study, request, worker_id, manifest, _study_span)
        return result

    def _run_study_traced(
        self, study: SyntheticStudy, request: DeidRequest, worker_id: str,
        manifest: Manifest, _study_span,
    ) -> StudyDeidResult:
        if self.lake is None:
            pairs = self._deid_datasets(study.datasets, request, worker_id)
            result = StudyDeidResult([], manifest)
        else:
            from repro_torch.lake.fingerprint import cache_key, instance_digest, request_salt
            from repro_torch.lake.records import decode_instance_record, encode_instance_record

            ruleset = self.ruleset_fingerprint().digest
            salt = request_salt(request)
            slots: List[Optional[Tuple[Optional[DicomDataset], ManifestEntry]]] = [
                None
            ] * len(study.datasets)
            cold: List[int] = []
            # the content-addressed keys hash every instance's pixels
            with self.tracer.stage("pipeline.lake", op="get", instances=len(slots)):
                keys = [
                    cache_key(instance_digest(ds), ruleset, salt) for ds in study.datasets
                ]
                for i, key in enumerate(keys):
                    blob = self.lake.get(key)
                    if blob is None:
                        cold.append(i)
                    else:
                        slots[i] = decode_instance_record(blob)
            cold_pairs = self._deid_datasets(
                [study.datasets[i] for i in cold], request, worker_id
            )
            assert len(cold_pairs) == len(cold)
            with self.tracer.stage("pipeline.lake", op="put", instances=len(cold)):
                for i, pair in zip(cold, cold_pairs):
                    slots[i] = pair
                    self.lake.put(keys[i], encode_instance_record(*pair))
            for s in slots:  # every instance is either a hit or a cold result
                assert s is not None
            pairs = slots  # type: ignore[assignment]
            result = StudyDeidResult(
                [], manifest, instance_keys=keys,
                cache_hits=len(keys) - len(cold), cache_misses=len(cold),
            )
        _study_span.set(lake_hits=result.cache_hits, cold=result.cache_misses)
        for out, entry in pairs:
            manifest.add(entry)
            if out is not None:
                result.delivered.append(out)
        self.ledger.append(
            DEID_EXECUTE,
            accession=request.accession,
            project=request.research_study,
            instances=len(study.datasets),
            lake_hits=result.cache_hits,
            cold=result.cache_misses,
            ruleset=self.ruleset_fingerprint().digest,
        )
        return result

    def process_study(
        self, study: SyntheticStudy, request: DeidRequest, worker_id: str = ""
    ) -> Tuple[List[DicomDataset], Manifest]:
        """Tuple façade over :meth:`run_study`. Delivered order and manifest
        contents are identical to :meth:`process_study_serial` (tested), which
        remains the per-instance fallback/oracle path."""
        result = self.run_study(study, request, worker_id)
        return result.delivered, result.manifest

    def process_study_serial(
        self, study: SyntheticStudy, request: DeidRequest, worker_id: str = ""
    ) -> Tuple[List[DicomDataset], Manifest]:
        """Per-instance oracle path (the pre-batching hot loop)."""
        manifest = Manifest(request_id=f"{request.research_study}/{request.anon_accession}")
        delivered: List[DicomDataset] = []
        for ds in study.datasets:
            out, entry = self.process_instance(ds, request, worker_id)
            manifest.add(entry)
            if out is not None:
                delivered.append(out)
        return delivered, manifest
