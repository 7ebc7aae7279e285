"""The port's fleet against the JAX package's where it works hardest: a live
PACS change feed under full chaos (pooler crashes, outages, duplicate and
out-of-order delivery, re-ingests routed through the feed, a ruleset
edit), and unknown-device traffic with the text-band detector on and off
(the PHI invariant's negative control). Runs compared field by field as in
``torch_fleet.py``; the port runs on ``device="cpu"``."""
import pytest

from torch_fleet import assert_same_fleet, corpus, run_both


def _feed(seed, n, ruleset_edits=0, **cfg):
    traffic = lambda m: m.BurstyTraffic(n_bursts=2, cohorts_per_burst=2,
                                        cohort_size=3).schedule(corpus(n), seed)
    chaos = lambda m: m.ChaosSchedule.seeded(
        seed, 600.0, corpus(n), crash_events=1, reingests=2, lease_storms=1,
        ruleset_edits=ruleset_edits, pooler_crashes=2, feed_outages=1, feed_faults=1)
    return (dict(seed=seed, n_studies=n, images_per_study=1, feed_mutations=12, **cfg),
            traffic, chaos)


def _unknown(seed, mode):
    return (dict(seed=seed, n_studies=6, modality="CT", images_per_study=3,
                 unknown_device_rate=0.5, detector_mode=mode), None, None)


_FLEETS = {
    "feed_chaos": _feed(11, 6),
    "feed_chaos_ruleset_edit": _feed(11, 6, ruleset_edits=1),
    "feed_conservation": (
        dict(seed=7, n_studies=5, images_per_study=1, feed_mutations=8),
        lambda m: m.BurstyTraffic(n_bursts=2, cohorts_per_burst=2,
                                  cohort_size=3).schedule(corpus(5), 7),
        lambda m: m.ChaosSchedule.seeded(7, 400.0, corpus(5))),
    "feed_small": (dict(seed=5, n_studies=3, images_per_study=1, feed_mutations=4), None, None),
    "unknown_devices": _unknown(5, "registry_first"),
    # the card run's configuration (chip_smoke.py path (j)) at 4 studies of
    # one image: modality mix, recompression, unknown devices, the feed,
    # queries beside cohorts and every chaos kind
    "mixed_recompress_all_chaos": (
        dict(seed=7, n_studies=4, images_per_study=1, modality=None, recompress=True,
             unknown_device_rate=0.25, feed_mutations=4),
        lambda m: (m.BurstyTraffic(n_bursts=2, cohorts_per_burst=2,
                                   cohort_size=2).schedule(corpus(4), 7)
                   + m.QueryMix(n_queries=3).schedule(corpus(4), 7)),
        lambda m: m.ChaosSchedule.seeded(
            7, 1800.0, corpus(4), crash_events=2, straggler_events=1, reingests=2,
            lease_storms=1, ruleset_edits=1, pooler_crashes=1, feed_outages=1,
            feed_faults=1)),
}


@pytest.mark.parametrize("name", sorted(_FLEETS))
def test_fleet_equals_reference(tmp_path, name):
    cfg_kw, traffic, chaos = _FLEETS[name]
    ts, tr, js, jr = run_both(tmp_path, name, cfg_kw, traffic, chaos)
    assert tr.ok(), [v.detail for v in tr.violations]
    assert_same_fleet(ts, tr, js, jr)
    if "feed_mutations" in cfg_kw:
        assert tr.metrics["feed_applied"] > 0
        assert not ts.pooler.behind() and ts.ingest_broker.empty()
    if name.startswith("feed_chaos"):
        assert tr.metrics["pooler_crashes"] == 2
        assert tr.metrics["feed_outage_polls"] > 0
        assert tr.metrics["feed_redelivered"] >= 1
        assert len(ts.ledger.records("ingest_apply")) == len(ts.applier.checkpoint.outcomes)
    if name == "unknown_devices":
        assert tr.metrics["unknown_device_lookups"] > 0
        assert tr.metrics["detector_detected"] > 0


def test_detector_off_fails_phi_like_the_reference(tmp_path):
    """Negative control: with the detector off, the unknown devices' burned-in
    text reaches the researcher in both packages, and both PHI checkers say
    so, violation for violation."""
    cfg_kw, traffic, chaos = _unknown(5, "off")
    ts, tr, js, jr = run_both(tmp_path, "ud_off", cfg_kw, traffic, chaos)
    assert not tr.ok()
    phi = [v for v in tr.violations if v.checker == "phi_boundary"]
    assert phi and any("text band" in v.detail for v in phi)
    assert [v.detail for v in phi] == [v.detail for v in jr.violations if v.checker == "phi_boundary"]
    assert tr.metrics["detector_runs"] == 0
    assert_same_fleet(ts, tr, js, jr)


def test_slo_conformance_fault_is_shared_with_reference(tmp_path):
    """A fault of both packages (ROADMAP section 3): when a source mutation
    re-publishes a key whose earlier serve is traced under the same
    (key, attempt) trace ids, ``derive_serve_observations`` pairs an ack
    with the wrong ``worker.process`` or publish span, and SloConformance
    reports a divergence the live observations do not have. The port keeps
    the reference's behaviour: the same violation on the same run."""
    names = corpus(2)
    traffic = lambda m: m.BurstyTraffic(n_bursts=2, cohorts_per_burst=2,
                                        cohort_size=2).schedule(names, 22)
    chaos = lambda m: m.ChaosSchedule.seeded(22, 600.0, names, crash_events=2, straggler_events=1,
                                             reingests=2, lease_storms=1, feed_faults=1)
    cfg_kw = dict(seed=22, n_studies=2, images_per_study=1, feed_mutations=6)
    ts, tr, js, jr = run_both(tmp_path, "slo_fault", cfg_kw, traffic, chaos)
    assert [(v.checker, v.detail) for v in tr.violations] == [
        (v.checker, v.detail) for v in jr.violations] == [
        ("slo_conformance",
         "cold-serve observations diverge from the span stream: 3 observed vs 2 derived")]
    assert_same_fleet(ts, tr, js, jr)
