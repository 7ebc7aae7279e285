"""ChangePooler + IngestApplier: continuous change-feed ingest (DESIGN.md §10).

The ingest process has two halves, modeled on ``research-pacs-on-aws``'s
``change_pooler``:

* :class:`ChangePooler` polls the PACS change sequence from the durable
  checkpoint's floor and hands each unseen event to the Broker —
  **at-least-once**: publish first, ``mark_seen`` second, so a crash between
  the two re-publishes and the applier dedups. Feed outages are absorbed by
  exponential backoff with seeded jitter; after ``breaker_threshold``
  consecutive failures the circuit breaker opens and polling stops entirely
  for ``breaker_cooldown`` seconds (no hammering a down PACS).
* :class:`IngestApplier` drains the broker and applies events to the imaging
  lake (:class:`~repro_torch.storage.object_store.StudyStore`), which cascades the
  catalog delta (tombstone + append / remove). Every apply is
  **effect-idempotent**: dedup by ``(accession, etag)`` via the checkpoint,
  per-accession seq ordering fences out-of-order deliveries (an older event
  can never clobber newer bytes), and redeliveries of an already-outcome'd
  seq are acked without effect. Applies read the PACS's *current* bytes, so
  a burst of updates collapses into one apply plus effect-dedups.

Everything is driven by the shared SimClock and HashRng — a pooler crash,
restart, and catch-up replays bit-identically from one seed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.audit.ledger import NULL_LEDGER
from repro_torch.audit.records import INGEST_APPLY
from repro_torch.ingest.checkpoint import Checkpoint
from repro_torch.ingest.feed import ChangeEvent, FeedOutage, PacsFeed
from repro_torch.obs.metrics import StatsShim
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.queueing.broker import Broker
from repro_torch.storage.object_store import StudyStore
from repro_torch.utils.logging import get_logger

log = get_logger("ingest.pooler")


class PoolerCrash(RuntimeError):
    """Injected crash mid-batch (chaos): in-memory state is lost; recovery
    replays the durable checkpoint."""


class PoolerStats(StatsShim):
    """Pooler counters as real metrics (``repro_ingest_*``)."""

    _SUBSYSTEM = "ingest"
    _FIELDS = (
        "polls",
        "handed",          # events published into the broker
        "duplicates",      # feed redeliveries dropped against the seen set
        "outages",         # polls that hit FeedOutage
        "backoff_skips",   # polls skipped inside a backoff window
        "breaker_skips",   # polls skipped while the breaker was open
        "breaker_opens",
    )


class ChangePooler:
    def __init__(
        self,
        feed: PacsFeed,
        broker: Broker,
        checkpoint: Checkpoint,
        clock,
        *,
        seed: int = 0,
        batch: int = 32,
        base_backoff: float = 5.0,
        max_backoff: float = 300.0,
        jitter: float = 0.5,
        breaker_threshold: int = 3,
        breaker_cooldown: float = 120.0,
        tracer=None,
        registry=None,
    ) -> None:
        self.feed = feed
        self.broker = broker
        self.checkpoint = checkpoint
        self.clock = clock
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._registry = registry
        self.batch = batch
        self.base_backoff = base_backoff
        self.max_backoff = max_backoff
        self.jitter = jitter
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.failures = 0
        self.next_poll_at = 0.0
        self.breaker_open_until: Optional[float] = None
        self.stats = PoolerStats(registry)
        # lazy import: repro_torch.sim's package __init__ imports the harness,
        # which imports this module (module-level import would be a cycle)
        from repro_torch.sim.events import HashRng

        self._rng = HashRng(seed, "pooler")

    def behind(self) -> bool:
        return self.checkpoint.floor() < self.feed.last_seq

    def poll_once(self, crash_after: Optional[int] = None) -> Dict[str, Any]:
        """One poll attempt at the current sim time. Returns a small status
        dict (logged by the harness). ``crash_after=k`` is the chaos hook:
        hand k events, publish the (k+1)-th WITHOUT marking it seen, then
        crash — the torn point the checkpoint contract must absorb."""
        now = self.clock.now()
        if self.breaker_open_until is not None:
            if now < self.breaker_open_until:
                self.stats.breaker_skips += 1
                return {"skipped": "breaker", "until": self.breaker_open_until}
            # half-open: one trial poll decides reset-or-reopen
            self.breaker_open_until = None
        if now < self.next_poll_at:
            self.stats.backoff_skips += 1
            return {"skipped": "backoff", "until": self.next_poll_at}
        self.stats.polls += 1
        # skipped polls (backoff/breaker, every idle tick) stay span-free;
        # only real poll attempts — including outages — leave a trace
        with self.tracer.span("ingest.poll") as _poll_span:
            return self._poll_traced(now, crash_after, _poll_span)

    def _poll_traced(
        self, now: float, crash_after: Optional[int], span
    ) -> Dict[str, Any]:
        try:
            batch = self.feed.poll(self.checkpoint.floor(), self.batch)
        except FeedOutage:
            self.failures += 1
            self.stats.outages += 1
            backoff = min(
                self.max_backoff, self.base_backoff * 2 ** (self.failures - 1)
            )
            # seeded jitter decorrelates retry herds without breaking replay
            backoff *= 1.0 + self.jitter * self._rng.u("jitter", self.failures)
            self.next_poll_at = now + backoff
            if self.failures >= self.breaker_threshold:
                self.breaker_open_until = now + self.breaker_cooldown
                self.stats.breaker_opens += 1
            span.set(kind="outage", error="FeedOutage")
            return {"outage": True, "failures": self.failures, "backoff": backoff}
        self.failures = 0
        handed = 0
        dups = 0
        events = sorted(batch, key=lambda e: e.seq)
        crash_at: Optional[int] = None
        if crash_after is not None:
            n_unseen = len({e.seq for e in events} - self.checkpoint.seen)
            if n_unseen:
                # clamp so an injected crash always fires mid-batch even when
                # the batch holds fewer unseen events than the requested offset
                crash_at = min(crash_after, n_unseen - 1)
        for event in events:
            if event.seq in self.checkpoint.seen:
                dups += 1
                self.stats.duplicates += 1
                continue
            # at-least-once handoff: publish BEFORE mark_seen; the applier's
            # (accession, etag) dedup makes the redelivery effect-idempotent
            self.broker.publish(
                key=f"feed/{event.accession}@{event.etag[:12]}#{event.seq}",
                payload={
                    "seq": event.seq,
                    "kind": event.kind,
                    "accession": event.accession,
                    "etag": event.etag,
                },
                nbytes=0,
            )
            if crash_at is not None and handed >= crash_at:
                raise PoolerCrash(
                    f"pooler crashed mid-batch after seq {event.seq} "
                    f"(published, not yet checkpointed)"
                )
            self.checkpoint.mark_seen(event.seq)
            handed += 1
            self.stats.handed += 1
        span.set(handed=handed, duplicates=dups, floor=self.checkpoint.floor())
        return {"handed": handed, "duplicates": dups, "floor": self.checkpoint.floor()}


class ApplierStats(StatsShim):
    """Applier counters as real metrics (``repro_applier_*``)."""

    _SUBSYSTEM = "applier"
    _FIELDS = (
        "applied",
        "deletes",
        "effect_deduped",  # same (accession, etag) already applied
        "stale_skipped",   # older than the newest applied event for the acc
        "redelivered",     # broker redeliveries of an already-outcome'd seq
    )


@dataclass
class AppliedOp:
    """What one apply actually did — the harness's bookkeeping handle."""

    seq: int
    op: str                  # "put" | "delete"
    accession: str
    etag: str                # PACS-side etag applied ("" for deletes)
    study: Any = None
    rows: int = 0


class IngestApplier:
    """Broker consumer that lands feed events in the lake, exactly once by
    effect. Shares the pooler's checkpoint — they are one ingest process."""

    def __init__(
        self,
        broker: Broker,
        feed: PacsFeed,
        store: StudyStore,
        checkpoint: Checkpoint,
        worker_id: str = "ingest-applier",
        tracer=None,
        registry=None,
        ledger=None,
    ) -> None:
        self.broker = broker
        self.feed = feed
        self.store = store
        self.checkpoint = checkpoint
        self.worker_id = worker_id
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.ledger = ledger if ledger is not None else NULL_LEDGER
        self.stats = ApplierStats(registry)

    def _outcome(
        self, seq: int, acc: str, etag: str, op: str, outcome: str, rows: int = 0
    ) -> None:
        """Checkpoint the terminal outcome AND audit it: every source
        mutation that reached a decision (applied / dup / stale) is a
        PHI-relevant change to what later deliveries will disclose."""
        self.checkpoint.mark_outcome(seq, acc, etag, op, outcome, rows=rows)
        self.ledger.append(
            INGEST_APPLY, feed_seq=seq, accession=acc, etag=etag, op=op,
            outcome=outcome, rows=rows,
        )

    def _apply_one(self, payload: Dict[str, Any]) -> Optional[AppliedOp]:
        ckpt = self.checkpoint
        seq = int(payload["seq"])
        acc = payload["accession"]
        etag = payload["etag"]
        kind = payload["kind"]
        if ckpt.has_outcome(seq):
            # redelivery (pooler crash between publish and mark_seen, or a
            # broker lease expiry): terminal outcome already recorded
            self.stats.redelivered += 1
            return None
        if seq < ckpt.applied_seq.get(acc, 0):
            # out-of-order: a newer event for this accession already landed —
            # applying the older one would regress the lake (freshness fence)
            self._outcome(seq, acc, etag, kind, "stale")
            self.stats.stale_skipped += 1
            return None
        if kind == "delete":
            self.store.delete_study(acc)
            self._outcome(seq, acc, "", "delete", "applied")
            self.stats.applied += 1
            self.stats.deletes += 1
            return AppliedOp(seq, "delete", acc, "")
        fetched = self.feed.fetch(acc)
        if fetched is None:
            # created/updated then deleted before we applied: the delete
            # event is (or will be) in the sequence — skip, don't resurrect
            self._outcome(seq, acc, etag, kind, "stale")
            self.stats.stale_skipped += 1
            return None
        study, current_etag = fetched
        if ckpt.applied_etag.get(acc) == current_etag:
            # effect-idempotent redelivery: these exact bytes already landed
            self._outcome(seq, acc, current_etag, kind, "dup")
            self.stats.effect_deduped += 1
            return None
        rows = len(study.datasets)
        # apply current bytes (not the event's snapshot): a burst of updates
        # collapses to one put + dups, and the lake never lags the last ack
        self.store.put_study(acc, study)
        self._outcome(seq, acc, current_etag, kind, "applied", rows=rows)
        self.stats.applied += 1
        return AppliedOp(seq, "put", acc, current_etag, study=study, rows=rows)

    def drain(self, max_messages: int = 256) -> List[AppliedOp]:
        """Pull-and-apply until the ingest queue is empty (bounded). Returns
        the ops that actually mutated the lake, in apply order."""
        out: List[AppliedOp] = []
        for _ in range(max_messages):
            msgs = self.broker.pull(self.worker_id, max_messages=1)
            if not msgs:
                break
            msg = msgs[0]
            with self.tracer.span(
                "ingest.apply",
                trace_id=None,
                key=msg.key,
                seq=int(msg.payload["seq"]),
                kind=msg.payload["kind"],
            ) as sp:
                applied = self._apply_one(msg.payload)
                if applied is not None:
                    out.append(applied)
                    sp.set(ok=True, rows=applied.rows)
                else:
                    sp.set(ok=False)
                self.broker.ack(msg.msg_id)
        return out
