"""Traffic models: seeded cohort-arrival schedules (DESIGN.md §7).

A traffic model turns (seed, corpus) into a flat, time-sorted list of
:class:`CohortArrival`\\ s before the simulation starts — arrivals are *data*,
not code, so the same seed always yields the same schedule and the event loop
never consults randomness at run time.

Three shapes, matching the operational patterns the paper's fleet must absorb:

* :class:`BurstyTraffic` — clustered cohort submissions (a lab submits its
  whole project at once), exponential gaps between bursts;
* :class:`DiurnalTraffic` — researcher-working-hours load over multiple
  simulated days, thinned at night;
* :class:`ReplayStorm` — one seeding cohort, then a storm of mostly-warm
  re-requests (the DESIGN.md §6 repeat-traffic regime, default 90% warm);
* :class:`QueryMix` — query-driven arrivals (DESIGN.md §8): researchers
  submit metadata *predicates*, not accession lists, and the catalog
  resolves the cohort at serve time. Selectivity knobs shape the mix from
  scan-everything sweeps to single-modality-single-year slivers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from repro_torch.catalog.query import And, Eq, Not, Or, Predicate, Range
from repro_torch.sim.events import HashRng


@dataclass(frozen=True)
class CohortArrival:
    t: float
    study_id: str           # research study (IRB protocol) submitting
    accessions: tuple       # imaging accessions requested (tuple: hashable/frozen)


@dataclass(frozen=True)
class QueryArrival:
    """A cohort request expressed as a metadata query. Predicates are frozen
    dataclasses, so arrivals stay hashable/replayable data just like
    accession tuples."""

    t: float
    study_id: str
    query: Predicate


class TrafficModel:
    """Base: subclasses implement :meth:`schedule`."""

    def schedule(self, corpus: Sequence[str], seed: int) -> List[CohortArrival]:
        raise NotImplementedError


@dataclass
class BurstyTraffic(TrafficModel):
    """Bursts of cohorts with exponential inter-burst gaps."""

    n_bursts: int = 3
    cohorts_per_burst: int = 2
    cohort_size: int = 4
    mean_gap: float = 600.0          # seconds between bursts
    intra_gap: float = 10.0          # seconds between cohorts inside a burst
    study_ids: Sequence[str] = ("IRB-A", "IRB-B")

    def schedule(self, corpus: Sequence[str], seed: int) -> List[CohortArrival]:
        rng = HashRng(seed, "bursty")
        out: List[CohortArrival] = []
        t = 0.0
        for b in range(self.n_bursts):
            if b:
                t += rng.exp(self.mean_gap, "gap", b)
            for c in range(self.cohorts_per_burst):
                accs = rng.sample(list(corpus), self.cohort_size, "cohort", b, c)
                out.append(
                    CohortArrival(
                        t=t + c * self.intra_gap,
                        study_id=rng.choice(list(self.study_ids), "study", b, c),
                        accessions=tuple(accs),
                    )
                )
        return sorted(out, key=lambda a: (a.t, a.study_id))


@dataclass
class DiurnalTraffic(TrafficModel):
    """Cohorts spread over ``days`` with a day/night density cycle: a cohort
    drawn for hour ``h`` survives with probability prop. to the diurnal
    weight, peaking mid-workday."""

    days: int = 2
    cohorts_per_day: int = 6
    cohort_size: int = 3
    study_ids: Sequence[str] = ("IRB-DAY",)

    @staticmethod
    def _weight(hour: float) -> float:
        # smooth bump centred on 13:00, near-zero at night
        return max(0.05, math.sin(math.pi * max(0.0, min(1.0, (hour - 7.0) / 12.0))))

    def schedule(self, corpus: Sequence[str], seed: int) -> List[CohortArrival]:
        rng = HashRng(seed, "diurnal")
        out: List[CohortArrival] = []
        for d in range(self.days):
            placed = 0
            slot = 0
            # draw candidate slots until the day's quota is placed (bounded)
            while placed < self.cohorts_per_day and slot < self.cohorts_per_day * 8:
                hour = 24.0 * rng.u("hour", d, slot)
                if rng.u("keep", d, slot) < self._weight(hour):
                    t = (d * 24.0 + hour) * 3600.0
                    accs = rng.sample(list(corpus), self.cohort_size, "cohort", d, slot)
                    out.append(
                        CohortArrival(
                            t=t,
                            study_id=rng.choice(list(self.study_ids), "study", d, slot),
                            accessions=tuple(accs),
                        )
                    )
                    placed += 1
                slot += 1
        return sorted(out, key=lambda a: (a.t, a.study_id))


@dataclass
class ReplayStorm(TrafficModel):
    """One seeding cohort over a base set, then ``n_replays`` cohorts drawing
    ``warm_fraction`` of their accessions from the (now warm) base set and
    the rest from the cold remainder — the 90%-warm storm regime."""

    warm_fraction: float = 0.9
    base_size: int = 6
    n_replays: int = 4
    cohort_size: int = 5
    gap: float = 120.0
    study_id: str = "IRB-STORM"

    def schedule(self, corpus: Sequence[str], seed: int) -> List[CohortArrival]:
        rng = HashRng(seed, "storm")
        corpus = list(corpus)
        base = rng.sample(corpus, min(self.base_size, len(corpus)), "base")
        cold_pool = [a for a in corpus if a not in set(base)]
        out = [CohortArrival(t=0.0, study_id=self.study_id, accessions=tuple(base))]
        for r in range(self.n_replays):
            n_warm = min(int(round(self.warm_fraction * self.cohort_size)), len(base))
            accs = rng.sample(base, n_warm, "warm", r)
            n_cold = self.cohort_size - n_warm
            if n_cold and cold_pool:
                accs = accs + rng.sample(cold_pool, n_cold, "cold", r)
            out.append(
                CohortArrival(
                    t=(r + 1) * self.gap, study_id=self.study_id, accessions=tuple(accs)
                )
            )
        return out


@dataclass
class QueryMix(TrafficModel):
    """Seeded mix of metadata queries with selectivity knobs.

    Five shapes, drawn per arrival: ``broad`` (a StudyDate range spanning the
    whole archive — selects ~everything), ``modality`` (one modality),
    ``year`` (one acquisition year), ``and`` (modality ∧ year — the narrow
    sliver), and ``negate`` (¬modality ∨ second modality — exercises NOT/OR
    through the bitmap path). The fractions are the selectivity knobs; they
    are weights over shapes, renormalized, so any subset can be zeroed.
    """

    n_queries: int = 6
    mean_gap: float = 240.0
    study_ids: Sequence[str] = ("IRB-Q",)
    modalities: Sequence[str] = ("CT", "MR", "DX", "CR", "US", "PT")
    years: Sequence[int] = (2015, 2016, 2017, 2018, 2019)
    broad_fraction: float = 0.2
    modality_fraction: float = 0.25
    year_fraction: float = 0.2
    and_fraction: float = 0.2
    negate_fraction: float = 0.15

    def _make_query(self, rng: HashRng, q: int) -> Predicate:
        mods = list(self.modalities)
        years = list(self.years)
        mod = rng.choice(mods, "mod", q)
        year = rng.choice(years, "year", q)
        year_range = Range("study_date", year * 10000 + 101, year * 10000 + 1231)
        weights = [
            ("broad", self.broad_fraction),
            ("modality", self.modality_fraction),
            ("year", self.year_fraction),
            ("and", self.and_fraction),
            ("negate", self.negate_fraction),
        ]
        total = sum(w for _, w in weights) or 1.0
        u = rng.u("shape", q) * total
        acc = 0.0
        shape = weights[-1][0]
        for name, w in weights:
            acc += w
            if u < acc:
                shape = name
                break
        if shape == "broad":
            lo, hi = min(years), max(years)
            return Range("study_date", lo * 10000 + 101, hi * 10000 + 1231)
        if shape == "modality":
            return Eq("modality", mod)
        if shape == "year":
            return year_range
        if shape == "and":
            return And(Eq("modality", mod), year_range)
        other = rng.choice(mods, "mod2", q)
        return Or(Not(Eq("modality", mod)), Eq("modality", other))

    def schedule(self, corpus: Sequence[str], seed: int) -> List[QueryArrival]:
        rng = HashRng(seed, "querymix")
        out: List[QueryArrival] = []
        t = 0.0
        for q in range(self.n_queries):
            if q:
                t += rng.exp(self.mean_gap, "gap", q)
            out.append(
                QueryArrival(
                    t=t,
                    study_id=rng.choice(list(self.study_ids), "study", q),
                    query=self._make_query(rng, q),
                )
            )
        return sorted(out, key=lambda a: (a.t, a.study_id))
