# The on-demand de-identification engine: filter -> scrub -> anonymize
# stages, pseudonymization, manifests, rule DSL, and the batched executor.
from repro_torch.core.batch import BatchedDeidExecutor
from repro_torch.core.pipeline import DeidPipeline, DeidRequest, StudyDeidResult, build_request
from repro_torch.core.pseudonym import PseudonymService, TrustMode
from repro_torch.core.manifest import Manifest, ManifestEntry, Outcome
from repro_torch.core.filter import FilterStage
from repro_torch.core.scrub import ScrubStage, ScrubError, numpy_blank
from repro_torch.core.anonymize import AnonymizerStage

__all__ = [
    "BatchedDeidExecutor",
    "DeidPipeline",
    "DeidRequest",
    "StudyDeidResult",
    "build_request",
    "PseudonymService",
    "TrustMode",
    "Manifest",
    "ManifestEntry",
    "Outcome",
    "FilterStage",
    "ScrubStage",
    "ScrubError",
    "numpy_blank",
    "AnonymizerStage",
]
