"""Chaos schedules: seeded fault timelines for the fleet simulator.

A chaos schedule is a time-sorted list of :class:`ChaosEvent`\\ s, fixed
before the run (same determinism contract as ``repro_torch.sim.traffic``). Kinds
the harness understands:

* ``set_crash_rate``   — retune `FailureInjector.crash_rate` mid-run
* ``crash_keys``       — crash the FIRST delivery of specific accessions
                         (`FailureInjector.crash_once_keys` semantics: a
                         no-op for keys already past delivery 1 — schedule
                         these before the targeted cohort arrives)
* ``set_straggler``    — retune straggler rate / slow factor
* ``lease_storm``      — temporarily shrink the broker visibility timeout,
                         forcing lease-expiry races against live workers
* ``reingest``         — overwrite a source study with re-acquired bytes
                         (new content ⇒ new etag) while work may be in flight
* ``ruleset_edit``     — swap the worker pipeline + planner onto an edited
                         ruleset (new fingerprint) mid-cohort
* ``pooler_crash``     — crash the change pooler mid-batch on its next poll
                         (``after`` events handed; recovery replays the
                         durable checkpoint)
* ``feed_outage``      — the PACS change feed raises outages for
                         ``duration`` seconds (backoff + breaker path)
* ``feed_faults``      — turn on duplicate/out-of-order delivery on the feed

Every mutation is applied *at* an event boundary by the harness, never inside
a worker round, so the interleaving is exact and replayable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence

from repro_torch.sim.events import HashRng

CHAOS_KINDS = (
    "set_crash_rate",
    "crash_keys",
    "set_straggler",
    "lease_storm",
    "reingest",
    "ruleset_edit",
    "pooler_crash",
    "feed_outage",
    "feed_faults",
)


@dataclass(frozen=True)
class ChaosEvent:
    t: float
    kind: str
    payload: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; one of {CHAOS_KINDS}")


@dataclass
class ChaosSchedule:
    events: List[ChaosEvent] = field(default_factory=list)

    def sorted(self) -> List[ChaosEvent]:
        return sorted(self.events, key=lambda e: (e.t, e.kind))

    @classmethod
    def quiet(cls) -> "ChaosSchedule":
        return cls([])

    @classmethod
    def seeded(
        cls,
        seed: int,
        horizon: float,
        corpus: Sequence[str],
        *,
        crash_events: int = 2,
        straggler_events: int = 1,
        reingests: int = 1,
        lease_storms: int = 1,
        ruleset_edits: int = 0,
        pooler_crashes: int = 0,
        feed_outages: int = 0,
        feed_faults: int = 0,
    ) -> "ChaosSchedule":
        """Hash-seeded schedule: event times and victims are pure functions of
        the seed, so a chaos run replays bit-identically."""
        rng = HashRng(seed, "chaos")
        corpus = list(corpus)
        ev: List[ChaosEvent] = []
        for i in range(crash_events):
            ev.append(
                ChaosEvent(
                    t=horizon * rng.u("crash_t", i),
                    kind="set_crash_rate",
                    payload={"rate": 0.1 + 0.3 * rng.u("crash_r", i)},
                )
            )
        for i in range(straggler_events):
            ev.append(
                ChaosEvent(
                    t=horizon * rng.u("slow_t", i),
                    kind="set_straggler",
                    payload={
                        "rate": 0.1 + 0.2 * rng.u("slow_r", i),
                        "slow_factor": float(rng.randint(5, 40, "slow_f", i)),
                    },
                )
            )
        for i in range(reingests):
            if corpus:
                ev.append(
                    ChaosEvent(
                        t=horizon * rng.u("reingest_t", i),
                        kind="reingest",
                        payload={"accession": rng.choice(corpus, "reingest_a", i)},
                    )
                )
        for i in range(lease_storms):
            ev.append(
                ChaosEvent(
                    t=horizon * rng.u("storm_t", i),
                    kind="lease_storm",
                    payload={
                        "visibility_timeout": float(rng.randint(5, 20, "storm_v", i)),
                        "duration": horizon * 0.1,
                    },
                )
            )
        for i in range(ruleset_edits):
            ev.append(
                ChaosEvent(
                    t=horizon * rng.u("edit_t", i),
                    kind="ruleset_edit",
                    payload={"edit_id": i + 1},
                )
            )
        for i in range(pooler_crashes):
            ev.append(
                ChaosEvent(
                    t=horizon * rng.u("pcrash_t", i),
                    kind="pooler_crash",
                    payload={"after": rng.randint(0, 3, "pcrash_k", i)},
                )
            )
        for i in range(feed_outages):
            ev.append(
                ChaosEvent(
                    t=horizon * rng.u("outage_t", i),
                    kind="feed_outage",
                    payload={"duration": horizon * (0.05 + 0.1 * rng.u("outage_d", i))},
                )
            )
        for i in range(feed_faults):
            ev.append(
                ChaosEvent(
                    t=horizon * rng.u("fault_t", i),
                    kind="feed_faults",
                    payload={
                        "dup_rate": 0.2 + 0.3 * rng.u("fault_r", i),
                        "shuffle": True,
                    },
                )
            )
        return cls(sorted(ev, key=lambda e: (e.t, e.kind)))
