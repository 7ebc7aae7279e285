# Continuous change-feed ingest (DESIGN.md §10): simulated PACS change
# sequence, durable crash-replayable checkpoint, at-least-once pooler handoff
# with effect-idempotent apply, backoff + circuit breaker for feed outages.
from repro_torch.ingest.checkpoint import Checkpoint
from repro_torch.ingest.feed import (
    ChangeEvent,
    FeedMutation,
    FeedOutage,
    PacsFeed,
    seeded_mutations,
)
from repro_torch.ingest.pooler import (
    AppliedOp,
    ApplierStats,
    ChangePooler,
    IngestApplier,
    PoolerCrash,
    PoolerStats,
)

__all__ = [
    "AppliedOp",
    "ApplierStats",
    "ChangeEvent",
    "ChangePooler",
    "Checkpoint",
    "FeedMutation",
    "FeedOutage",
    "IngestApplier",
    "PacsFeed",
    "PoolerCrash",
    "PoolerStats",
    "seeded_mutations",
]
