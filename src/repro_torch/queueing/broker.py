"""Publish/subscribe message broker with cloud Pub/Sub semantics.

The paper's pipeline "listens for de-identification requests using a
publish/subscribe messaging model". We reproduce the semantics that matter
for correctness at scale — **at-least-once delivery** with visibility-timeout
leases, nack/redelivery, a dead-letter queue after ``max_deliveries``, and
backlog statistics the autoscaler consumes — as a deterministic in-process
simulation driven by an injectable clock (`repro_torch.utils.timing.SimClock`).

Exactly-once *effect* is layered on top by `repro_torch.queueing.journal` (dedup on
message key), the standard cloud pattern.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.audit.ledger import NULL_LEDGER
from repro_torch.audit.records import DEAD_LETTER as AUDIT_DEAD_LETTER
from repro_torch.obs.metrics import StatsShim
from repro_torch.obs.trace import NULL_TRACER, trace_id_for
from repro_torch.utils.timing import SimClock


@dataclass
class Message:
    key: str                  # stable identity (accession), dedup handle
    payload: Any
    nbytes: int = 0           # payload size estimate for backlog stats
    msg_id: int = 0
    deliveries: int = 0
    publish_time: float = 0.0
    lease_deadline: Optional[float] = None
    lease_owner: Optional[str] = None


@dataclass
class QueueStats:
    outstanding: int      # available + leased (not yet acked)
    available: int
    leased: int
    dead_lettered: int
    backlog_bytes: int    # live work only — DLQ'd payloads are excluded, so
                          # the autoscaler never scales against dead work
    oldest_publish_time: Optional[float]
    dead_letter_bytes: int = 0  # poisoned payload bytes, reported separately


class BrokerCounters(StatsShim):
    """Lifetime broker counters as real metrics (``repro_broker_*``).

    ``deliveries`` counts leases handed out by :meth:`Broker.pull` and
    ``speculative_clones`` counts :meth:`Broker.speculative_redeliver` copies
    — together they close the conservation identities the sim's
    ``MetricsConservation`` checker audits.
    """

    _SUBSYSTEM = "broker"
    _FIELDS = (
        "published",
        "acked",
        "redelivered",
        "deliveries",
        "speculative_clones",
        "dead_lettered",
    )


class Broker:
    def __init__(
        self,
        clock: Optional[SimClock] = None,
        visibility_timeout: float = 120.0,
        max_deliveries: int = 5,
        tracer=None,
        registry=None,
        ledger=None,
    ) -> None:
        self.clock = clock or SimClock()
        self.visibility_timeout = visibility_timeout
        self.max_deliveries = max_deliveries
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.ledger = ledger if ledger is not None else NULL_LEDGER
        self.counters = BrokerCounters(registry)
        self._ids = itertools.count(1)
        self._available: List[Message] = []
        self._leased: Dict[int, Message] = {}
        self._acked_keys: set[str] = set()
        self.dead_letter: List[Message] = []

    # lifetime counters kept as properties so existing `broker.total_*`
    # call sites (and += writes) keep working on top of the metrics shim
    @property
    def total_published(self) -> int:
        return self.counters.published

    @total_published.setter
    def total_published(self, v: int) -> None:
        self.counters.published = v

    @property
    def total_acked(self) -> int:
        return self.counters.acked

    @total_acked.setter
    def total_acked(self, v: int) -> None:
        self.counters.acked = v

    @property
    def total_redelivered(self) -> int:
        return self.counters.redelivered

    @total_redelivered.setter
    def total_redelivered(self, v: int) -> None:
        self.counters.redelivered = v

    # ------------------------------------------------------------ publish
    def publish(self, key: str, payload: Any, nbytes: int = 0) -> int:
        msg = Message(
            key=key,
            payload=payload,
            nbytes=nbytes,
            msg_id=next(self._ids),
            publish_time=self.clock.now(),
        )
        self._available.append(msg)
        self.total_published += 1
        # the work item's first delivery attempt owns this trace id; the
        # publish event carries it so a trace links submit -> worker
        self.tracer.event(
            "broker.publish",
            trace_id=trace_id_for(key, 1),
            key=key,
            nbytes=nbytes,
        )
        return msg.msg_id

    # -------------------------------------------------------------- lease
    def _expire_leases(self) -> None:
        now = self.clock.now()
        expired = [m for m in self._leased.values() if m.lease_deadline is not None and m.lease_deadline <= now]
        for m in expired:
            del self._leased[m.msg_id]
            m.lease_owner = None
            m.lease_deadline = None
            if m.deliveries >= self.max_deliveries:
                self.dead_letter.append(m)
                self.counters.dead_lettered += 1
                self.tracer.event(
                    "broker.dead_letter",
                    trace_id=trace_id_for(m.key, m.deliveries),
                    key=m.key,
                    deliveries=m.deliveries,
                )
                self.ledger.append(
                    AUDIT_DEAD_LETTER, key=m.key, deliveries=m.deliveries, reason="lease_expired"
                )
            else:
                # fresh id per delivery = per-delivery ack token: a stale ack
                # from the crashed owner can never ack the new lease
                m.msg_id = next(self._ids)
                self._available.append(m)
                self.total_redelivered += 1
                self.tracer.event(
                    "broker.redeliver",
                    trace_id=trace_id_for(m.key, m.deliveries + 1),
                    key=m.key,
                    deliveries=m.deliveries,
                    kind="lease_expired",
                )

    def pull(self, worker_id: str, max_messages: int = 1) -> List[Message]:
        """Lease up to ``max_messages``; invisible to others until ack/timeout.
        Returns per-delivery *receipts* (copies): msg_id acts as the ack token
        for this delivery only, like cloud Pub/Sub ack ids."""
        self._expire_leases()
        out: List[Message] = []
        while self._available and len(out) < max_messages:
            msg = self._available.pop(0)
            msg.deliveries += 1
            msg.lease_owner = worker_id
            msg.lease_deadline = self.clock.now() + self.visibility_timeout
            self._leased[msg.msg_id] = msg
            self.counters.deliveries += 1
            self.tracer.event(
                "broker.lease",
                trace_id=trace_id_for(msg.key, msg.deliveries),
                key=msg.key,
                deliveries=msg.deliveries,
                worker=worker_id,
                visibility=self.visibility_timeout,
            )
            out.append(Message(**vars(msg)))
        return out

    def extend_lease(self, msg_id: int, extra: float) -> bool:
        """Heartbeat: push this delivery's lease deadline out by ``extra``
        seconds. Returns False when the lease is gone — already acked, or
        expired (the message has been redelivered under a fresh ack token) —
        so the caller knows it is a zombie and must abort rather than ack."""
        self._expire_leases()
        msg = self._leased.get(msg_id)
        if msg is None:
            return False
        msg.lease_deadline += extra
        return True

    # ---------------------------------------------------------------- ack
    def ack(self, msg_id: int) -> bool:
        msg = self._leased.pop(msg_id, None)
        if msg is None:
            return False  # lease already expired; redelivery will be deduped
        self._acked_keys.add(msg.key)
        self.total_acked += 1
        self.tracer.event(
            "broker.ack",
            trace_id=trace_id_for(msg.key, msg.deliveries),
            key=msg.key,
            deliveries=msg.deliveries,
        )
        return True

    def nack(self, msg_id: int) -> None:
        """Immediate negative ack: back to the queue (or DLQ if exhausted)."""
        msg = self._leased.pop(msg_id, None)
        if msg is None:
            return
        msg.lease_owner = None
        msg.lease_deadline = None
        if msg.deliveries >= self.max_deliveries:
            self.dead_letter.append(msg)
            self.counters.dead_lettered += 1
            self.tracer.event(
                "broker.dead_letter",
                trace_id=trace_id_for(msg.key, msg.deliveries),
                key=msg.key,
                deliveries=msg.deliveries,
            )
            self.ledger.append(
                AUDIT_DEAD_LETTER, key=msg.key, deliveries=msg.deliveries, reason="nack"
            )
        else:
            msg.msg_id = next(self._ids)  # fresh ack token (see _expire_leases)
            self._available.append(msg)
            self.total_redelivered += 1
            self.tracer.event(
                "broker.redeliver",
                trace_id=trace_id_for(msg.key, msg.deliveries + 1),
                key=msg.key,
                deliveries=msg.deliveries,
                kind="nack",
            )

    # -------------------------------------------------------------- stats
    def stats(self) -> QueueStats:
        self._expire_leases()
        msgs = self._available + list(self._leased.values())
        return QueueStats(
            outstanding=len(msgs),
            available=len(self._available),
            leased=len(self._leased),
            dead_lettered=len(self.dead_letter),
            backlog_bytes=sum(m.nbytes for m in msgs),
            oldest_publish_time=min((m.publish_time for m in msgs), default=None),
            dead_letter_bytes=sum(m.nbytes for m in self.dead_letter),
        )

    def empty(self) -> bool:
        s = self.stats()
        return s.outstanding == 0

    def has_live(self, key: str) -> bool:
        """Any copy of ``key`` still available or leased (speculative clones
        of a dead-lettered delivery may outlive it and complete normally)."""
        self._expire_leases()
        return any(m.key == key for m in self._available) or any(
            m.key == key for m in self._leased.values()
        )

    # straggler mitigation support: leases held longer than ``age`` seconds
    def stale_leases(self, age: float) -> List[Message]:
        now = self.clock.now()
        return [
            m
            for m in self._leased.values()
            if now - (m.lease_deadline - self.visibility_timeout) >= age
        ]

    def speculative_redeliver(self, msg_id: int) -> Optional[Message]:
        """Clone a stale leased message back onto the queue (first ack wins —
        the journal dedups the second completion)."""
        msg = self._leased.get(msg_id)
        if msg is None:
            return None
        clone = Message(
            key=msg.key,
            payload=msg.payload,
            nbytes=msg.nbytes,
            msg_id=next(self._ids),
            deliveries=msg.deliveries,
            publish_time=msg.publish_time,
        )
        self._available.append(clone)
        self.counters.speculative_clones += 1
        self.tracer.event(
            "broker.redeliver",
            trace_id=trace_id_for(msg.key, msg.deliveries + 1),
            key=msg.key,
            deliveries=msg.deliveries,
            kind="speculative",
        )
        return clone
