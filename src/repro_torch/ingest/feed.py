"""Simulated clinical PACS change feed (ROADMAP: modeled on
``research-pacs-on-aws``'s change pooler source).

The PACS is the system of record: it commits create/update/delete mutations
to its own study inventory and appends one :class:`ChangeEvent` per commit to
a **monotonic change sequence**. Consumers poll the sequence with an
``after_seq`` cursor and fetch current study bytes separately — exactly the
DICOMweb changefeed shape, minus the network.

Delivery is deliberately imperfect, because that is what the pooler must be
robust to:

* ``outage`` — polls raise :class:`FeedOutage` (the pooler's backoff +
  circuit-breaker path);
* ``dup_rate`` — events may be delivered again in the same batch
  (at-least-once transport);
* ``shuffle`` — batch order is permuted (out-of-order delivery).

All delivery faults are drawn from :class:`repro_torch.sim.events.HashRng` keyed by
(seed, poll counter, event seq), so a faulty feed is still a pure function of
its seed — the fleet simulator's bit-replayability contract extends through
the feed.
"""
from __future__ import annotations

import hashlib
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.dicom.generator import StudyGenerator, SyntheticStudy

# NOTE: repro_torch.sim.events.HashRng is imported lazily below — repro_torch.sim's
# package __init__ pulls in the fleet harness, which imports this module
# (module-level import here would be a cycle).


class FeedOutage(RuntimeError):
    """The change feed is unreachable (network partition, PACS maintenance)."""


@dataclass(frozen=True)
class ChangeEvent:
    """One committed PACS mutation. ``etag`` is the PACS-side content digest
    of the committed version (empty for deletes) — the handoff dedup handle."""

    seq: int
    kind: str        # "create" | "update" | "delete"
    accession: str
    etag: str
    version: int


@dataclass(frozen=True)
class FeedMutation:
    """A scheduled PACS-side mutation (the feed's traffic model): data, not
    code, fixed before the run like every other simulator schedule."""

    t: float
    op: str          # "create" | "update" | "delete"
    accession: str


def seeded_mutations(
    seed: int,
    horizon: float,
    corpus: Sequence[str],
    n: int,
    *,
    create_fraction: float = 0.25,
    delete_fraction: float = 0.15,
) -> List[FeedMutation]:
    """Hash-seeded mutation schedule. Times are strictly increasing by
    construction (slot i lands in the i-th of n equal windows), so a delete is
    always scheduled after the create it targets. Deletes only target
    feed-created accessions — the initial corpus is referenced by traffic
    schedules built before the run, and deleting from under a scheduled cohort
    is a separate, explicitly-constructed experiment."""
    from repro_torch.sim.events import HashRng

    rng = HashRng(seed, "feed-schedule")
    corpus = list(corpus)
    created: List[str] = []
    out: List[FeedMutation] = []
    for i in range(n):
        t = horizon * (i + rng.u("t", i)) / max(n, 1)
        u = rng.u("op", i)
        if u < create_fraction or not (corpus or created):
            acc = f"PACS{i:04d}"
            created.append(acc)
            out.append(FeedMutation(t, "create", acc))
        elif u < create_fraction + delete_fraction and created:
            acc = rng.choice(created, "del", i)
            created.remove(acc)
            out.append(FeedMutation(t, "delete", acc))
        else:
            pool = corpus + created
            out.append(FeedMutation(t, "update", rng.choice(pool, "upd", i)))
    return out


class PacsFeed:
    """The simulated PACS: committed study inventory + monotonic change log."""

    def __init__(
        self,
        seed: int,
        modality: Optional[str] = "CT",
        images_per_study: int = 3,
    ) -> None:
        self.seed = seed
        self.modality = modality
        self.images_per_study = images_per_study
        self._studies: Dict[str, SyntheticStudy] = {}
        self._etags: Dict[str, str] = {}
        self._versions: Dict[str, int] = {}
        self.events: List[ChangeEvent] = []
        self.last_seq = 0
        # delivery-fault knobs (chaos-tunable)
        self.outage = False
        self.dup_rate = 0.0
        self.shuffle = False
        self._polls = 0
        from repro_torch.sim.events import HashRng

        self._rng = HashRng(seed, "pacs-feed")

    # ------------------------------------------------------------- commit side
    @staticmethod
    def _content_etag(study: SyntheticStudy) -> str:
        return hashlib.sha256(
            pickle.dumps(study, protocol=pickle.HIGHEST_PROTOCOL)
        ).hexdigest()

    def adopt(self, accession: str, study: SyntheticStudy) -> None:
        """Register an already-lake-resident study as version 0 without
        emitting a change event (the initial corpus predates the feed)."""
        self._studies[accession] = study
        self._etags[accession] = self._content_etag(study)
        self._versions[accession] = 0

    def commit(self, op: str, accession: str) -> Optional[ChangeEvent]:
        """Commit one mutation to the PACS and append its change event.
        Returns None for no-op commits (delete of an absent accession)."""
        if op == "delete":
            if accession not in self._studies:
                return None
            self._studies.pop(accession)
            self._etags.pop(accession)
            version = self._versions[accession]
            etag = ""
        elif op in ("create", "update"):
            version = self._versions.get(accession, 0) + 1
            # per-version generator seed: re-acquired bytes must differ from
            # every earlier version (new content => new etag)
            gen = StudyGenerator(self.seed + 7919 * version + 104729)
            study = gen.gen_study(
                accession, modality=self.modality, n_images=self.images_per_study
            )
            self._studies[accession] = study
            etag = self._content_etag(study)
            self._etags[accession] = etag
        else:
            raise ValueError(f"unknown feed op {op!r}")
        self._versions[accession] = version
        self.last_seq += 1
        ev = ChangeEvent(self.last_seq, op, accession, etag, version)
        self.events.append(ev)
        return ev

    # -------------------------------------------------------------- fetch side
    def fetch(self, accession: str) -> Optional[Tuple[SyntheticStudy, str]]:
        """Current committed (study, etag), or None when deleted/unknown."""
        study = self._studies.get(accession)
        if study is None:
            return None
        return study, self._etags[accession]

    def accessions(self) -> List[str]:
        return sorted(self._studies)

    # --------------------------------------------------------------- poll side
    def poll(self, after_seq: int, limit: int = 32) -> List[ChangeEvent]:
        """Events with ``seq > after_seq`` (at most ``limit`` distinct), with
        seeded duplicate/out-of-order delivery faults applied on top."""
        if self.outage:
            raise FeedOutage("change feed unreachable")
        self._polls += 1
        batch = [e for e in self.events if e.seq > after_seq][:limit]
        if self.dup_rate > 0.0:
            dups = [
                e for e in batch
                if self._rng.u("dup", self._polls, e.seq) < self.dup_rate
            ]
            batch = batch + dups
        if self.shuffle and len(batch) > 1:
            # permute by per-(poll, seq) draw; duplicates share a key, and
            # sorted() is stable, so the permutation is fully deterministic
            batch = sorted(
                batch, key=lambda e: self._rng.u("shuffle", self._polls, e.seq)
            )
        return batch
