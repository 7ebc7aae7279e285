# Content-addressed de-identification result lake (DESIGN.md §6): ruleset-
# versioned cache keys, LRU-bounded result store, and the cohort planner with
# single-flight request coalescing.
#
# NOTE: planner must be imported last — it pulls in repro_torch.core.pipeline and
# repro_torch.queueing, whose modules import repro_torch.lake.fingerprint/records back.
from repro_torch.lake.fingerprint import (
    RulesetFingerprint,
    cache_key,
    geometry_digest,
    instance_digest,
    request_salt,
    study_key,
)
from repro_torch.lake.records import (
    decode_instance_record,
    decode_study_record,
    encode_instance_record,
    encode_study_record,
)
from repro_torch.lake.store import InMemoryBackend, LakeBackend, LakeStats, ResultLake
from repro_torch.lake.planner import CohortPlanner, CohortTicket, PlannerStats

__all__ = [
    "RulesetFingerprint",
    "cache_key",
    "geometry_digest",
    "instance_digest",
    "request_salt",
    "study_key",
    "encode_instance_record",
    "decode_instance_record",
    "encode_study_record",
    "decode_study_record",
    "ResultLake",
    "LakeBackend",
    "InMemoryBackend",
    "LakeStats",
    "CohortPlanner",
    "CohortTicket",
    "PlannerStats",
]
