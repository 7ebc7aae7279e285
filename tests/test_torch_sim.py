"""The port's fleet simulator (``repro_torch.sim``) against the JAX
package's: equal traffic and chaos schedules, and equal fleet runs at the
configurations of ``tests/test_sim.py`` (metrics, event log record by
record, mutation and delivery logs, spans, ledger kinds, delivered
instances; stored sizes and etags compared through what they name, see
``torch_fleet.py``). The port runs on ``device="cpu"``."""
import pytest
import torch

import repro.catalog as RC
import repro.sim as R
import repro_torch.catalog as TC
import repro_torch.sim as T
from torch_fleet import assert_same_fleet, corpus, run_both


# ------------------------------------------------------------- schedules
def _arrivals(schedule):
    return [(a.t, a.study_id, getattr(a, "accessions", None),
             repr(getattr(a, "query", None))) for a in schedule]


_MODELS = {
    "bursty": lambda m: m.BurstyTraffic(),
    "bursty_wide": lambda m: m.BurstyTraffic(n_bursts=3, cohorts_per_burst=2, cohort_size=6),
    "diurnal": lambda m: m.DiurnalTraffic(days=2),
    "storm": lambda m: m.ReplayStorm(),
    "storm_cold": lambda m: m.ReplayStorm(warm_fraction=0.5, base_size=4, cohort_size=6),
    "query_mix": lambda m: m.QueryMix(n_queries=8),
    "query_modality": lambda m: m.QueryMix(n_queries=6, broad_fraction=0, year_fraction=0,
                                           and_fraction=0, negate_fraction=0,
                                           modality_fraction=1.0),
}


@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("model", sorted(_MODELS))
def test_traffic_schedule_equals_reference(model, seed):
    names = corpus(24)
    port = _MODELS[model](T).schedule(names, seed)
    jax = _MODELS[model](R).schedule(names, seed)
    assert port and _arrivals(port) == _arrivals(jax)
    assert [a.t for a in port] == sorted(a.t for a in port)


@pytest.mark.parametrize("seed", [3, 7, 11, 9])
def test_chaos_schedule_equals_reference(seed):
    names = corpus(24)
    kw = dict(crash_events=2, straggler_events=1, reingests=2, lease_storms=1,
              ruleset_edits=1, pooler_crashes=1, feed_outages=1, feed_faults=1)
    port = T.ChaosSchedule.seeded(seed, 1800.0, names, **kw).sorted()
    jax = R.ChaosSchedule.seeded(seed, 1800.0, names, **kw).sorted()
    assert len(port) == 10
    assert [(e.t, e.kind, e.payload) for e in port] == [(e.t, e.kind, e.payload) for e in jax]


def test_chaos_kinds_and_validation_match_reference():
    from repro.sim.chaos import CHAOS_KINDS as JAX_KINDS
    from repro_torch.sim.chaos import CHAOS_KINDS

    assert CHAOS_KINDS == JAX_KINDS
    with pytest.raises(ValueError, match="unknown chaos kind"):
        T.ChaosEvent(0.0, "meteor_strike")


def test_sim_exports_the_reference_names():
    assert sorted(T.__all__) == sorted(R.__all__)
    assert len(T.__all__) == 34


# ------------------------------------------------------------- fleets
def _bursty(seed, n):
    return lambda m: m.BurstyTraffic(n_bursts=2, cohorts_per_burst=2,
                                     cohort_size=3).schedule(corpus(n), seed)


def _seeded_chaos(seed, n, horizon=400.0, **kw):
    return lambda m: m.ChaosSchedule.seeded(seed, horizon, corpus(n), **kw)


_TINY = dict(images_per_study=1)

# (FleetConfig kwargs, traffic, chaos) at the configurations of test_sim.py
_FLEETS = {
    "quiet": (dict(seed=5, n_studies=3, **_TINY), None, None),
    "bursty_seeded_chaos": (dict(seed=9, n_studies=5, **_TINY), _bursty(9, 5),
                            _seeded_chaos(9, 5)),
    "replay_storm": (dict(seed=1, n_studies=4, **_TINY),
                     lambda m: m.ReplayStorm(base_size=3, n_replays=1,
                                             cohort_size=3).schedule(corpus(4), 1), None),
    "query_mix": (dict(seed=11, n_studies=6, modality=None, delivery_window=3600.0, **_TINY),
                  lambda m: m.QueryMix(n_queries=5).schedule(corpus(6), 11), None),
    "cohort_and_query": (
        dict(seed=5, n_studies=4, delivery_window=3600.0, **_TINY),
        lambda m: [
            m.CohortArrival(t=0.0, study_id="IRB-T", accessions=tuple(corpus(4)[:2])),
            m.QueryArrival(t=60.0, study_id="IRB-T",
                           query=(TC if m is T else RC).Range("study_date", 0, 99999999)),
        ], None),
    "query_reingest": (
        dict(seed=5, n_studies=4, modality=None, delivery_window=3600.0, **_TINY),
        lambda m: m.QueryMix(n_queries=4, mean_gap=120.0).schedule(corpus(4), 5),
        lambda m: m.ChaosSchedule([m.ChaosEvent(t=100.0, kind="reingest",
                                                payload={"accession": "SIM0001"})])),
    "crashes_stragglers_storm": (
        dict(seed=5, n_studies=4, **_TINY),
        lambda m: [m.CohortArrival(0.0, "IRB-C", tuple(corpus(4))),
                   m.CohortArrival(200.0, "IRB-C", tuple(corpus(4)))],
        lambda m: m.ChaosSchedule([
            m.ChaosEvent(0.0, "set_crash_rate", {"rate": 0.4}),
            m.ChaosEvent(50.0, "set_straggler", {"rate": 0.3, "slow_factor": 30.0}),
            m.ChaosEvent(80.0, "lease_storm", {"visibility_timeout": 8.0, "duration": 60.0}),
        ])),
    "overlapping_storms": (
        dict(seed=5, n_studies=3, **_TINY), None,
        lambda m: m.ChaosSchedule([
            m.ChaosEvent(0.0, "lease_storm", {"visibility_timeout": 5.0, "duration": 40.0}),
            m.ChaosEvent(10.0, "lease_storm", {"visibility_timeout": 12.0, "duration": 60.0}),
        ])),
    "dead_letter": (
        dict(seed=5, n_studies=3, max_deliveries=1, **_TINY), None,
        lambda m: m.ChaosSchedule([m.ChaosEvent(0.0, "crash_keys",
                                                {"accessions": ["SIM0001"]})])),
    "reingest_ruleset_edit": (
        dict(seed=5, n_studies=3, **_TINY),
        lambda m: [m.CohortArrival(0.0, "IRB-R", tuple(corpus(3))),
                   m.CohortArrival(300.0, "IRB-R", tuple(corpus(3))),
                   m.CohortArrival(600.0, "IRB-R2", tuple(corpus(3)))],
        lambda m: m.ChaosSchedule([
            m.ChaosEvent(320.0, "reingest", {"accession": "SIM0000"}),
            m.ChaosEvent(340.0, "ruleset_edit", {"edit_id": 1}),
        ])),
    "trace_and_audit_off": (dict(seed=9, n_studies=5, trace=False, audit=False, **_TINY),
                            _bursty(9, 5), _seeded_chaos(9, 5)),
    "slo_autoscale": (dict(seed=3, n_studies=5, slo_autoscale=True, **_TINY),
                      _bursty(3, 5), _seeded_chaos(3, 5)),
    "slo_off": (dict(seed=3, n_studies=5, slo=False, **_TINY), _bursty(3, 5),
                _seeded_chaos(3, 5)),
}


@pytest.mark.parametrize("name", sorted(_FLEETS))
def test_fleet_equals_reference(tmp_path, name):
    cfg_kw, traffic, chaos = _FLEETS[name]
    ts, tr, js, jr = run_both(tmp_path, name, cfg_kw, traffic, chaos)
    assert tr.ok(), [v.detail for v in tr.violations]
    assert_same_fleet(ts, tr, js, jr)


def test_fleet_config_fields_equal_reference():
    """One dict of fields builds both packages' configs: the device is an
    argument of FleetSim, not a config field."""
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(T.FleetConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(R.FleetConfig)]


def test_fleet_default_device_is_the_card_without_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.FleetConfig(seed=5, n_studies=1, images_per_study=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.FleetSim(cfg, [], tmp_path / "j.jsonl")
