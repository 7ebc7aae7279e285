"""The port's change-feed ingest (``ingest/{feed,checkpoint,pooler}``,
``sim/events.HashRng``) against the JAX package's.

A same-seed mutation schedule is committed to each package's ``PacsFeed``
(delivery faults on: duplicates and shuffled batches) over the same adopted
corpus (the port's studies are the JAX studies carried across), and drained
through ``ChangePooler`` -> broker -> ``IngestApplier`` into a ``StudyStore``
with a catalog, with ``PoolerCrash``es mid-batch and restarts from the
durable ``Checkpoint``. The applied-op sequences (seq, op, accession, rows),
the checkpoint outcome logs, the pooler and applier counters and the catalog
selections must be equal. Etags are content digests of pickles that name
their package's module, so each is compared through what it names: the
(accession, version) of the feed commit, or the accession of the adopted
study; a selection's digest is compared by re-ingesting under the JAX
etags. Then ``benchmarks/ingestbench.py``'s incremental re-de-identification
scenario (6 CT studies, 2 mutated) on each package: amplification exactly
1.0, 2 journal supersessions, 2 stale evictions.
"""
import dataclasses
import importlib
import types

import pytest

from repro.dicom.generator import StudyGenerator

from repro_torch.carry import study_from_plain, study_to_plain

SEED = 3
N_INITIAL = 4
N_MUTATIONS = 14
BATCH = 3
CRASH_POLLS = (1, 4)  # pooler polls that crash mid-batch


def _package(name):
    def mod(path):
        return importlib.import_module(f"{name}.{path}")

    catalog = mod("catalog")
    return types.SimpleNamespace(
        name=name, ingest=mod("ingest"), events=mod("sim.events"), broker=mod("queueing.broker"),
        store=mod("storage.object_store"), timing=mod("utils.timing"), catalog=catalog,
        make_catalog=(lambda: catalog.StudyCatalog(device="cpu")) if name == "repro_torch"
        else catalog.StudyCatalog,
    )


JAX, PORT = _package("repro"), _package("repro_torch")


def _corpus():
    gen = StudyGenerator(SEED)
    jax = [gen.gen_study(f"ACC{i:04d}", modality="CT", n_images=1) for i in range(N_INITIAL)]
    return jax, [study_from_plain(study_to_plain(s)) for s in jax]


def _run(pkg, studies, tmp):
    ing = pkg.ingest
    clock = pkg.timing.SimClock()
    feed = ing.PacsFeed(SEED, modality="CT", images_per_study=1)
    feed.dup_rate, feed.shuffle = 0.3, True
    store = pkg.store.StudyStore("lake", key=b"k")
    store.attach_catalog(pkg.make_catalog())
    adopted = {}
    for s in studies:
        store.put_study(s.accession, s)
        feed.adopt(s.accession, s)
        adopted[feed.fetch(s.accession)[1]] = (s.accession, 0)
    schedule = ing.seeded_mutations(SEED, 600.0, [s.accession for s in studies], N_MUTATIONS)
    for mut in schedule:
        feed.commit(mut.op, mut.accession)
    broker = pkg.broker.Broker(clock, visibility_timeout=60.0)
    path = tmp / f"{pkg.name}.ckpt"

    def process(ckpt):
        return (ing.ChangePooler(feed, broker, ckpt, clock, seed=SEED, batch=BATCH),
                ing.IngestApplier(broker, feed, store, ckpt))

    pooler, applier = process(ing.Checkpoint(path))
    applied, crashes, stats = [], 0, []
    for poll in range(200):
        if not pooler.behind() and broker.empty():
            break
        try:
            pooler.poll_once(crash_after=1 if poll in CRASH_POLLS else None)
        except ing.PoolerCrash:
            crashes += 1
            stats.append((pooler.stats.as_dict(), applier.stats.as_dict()))
            pooler.checkpoint.close()
            pooler, applier = process(ing.Checkpoint(path))
        applied += applier.drain()
        clock.advance(30.0)
    assert not pooler.behind() and broker.empty()
    stats.append((pooler.stats.as_dict(), applier.stats.as_dict()))
    pooler.checkpoint.close()
    names = dict(adopted)
    names.update({e.etag: (e.accession, e.version) for e in feed.events if e.etag})
    return types.SimpleNamespace(
        schedule=schedule, feed=feed, store=store, applied=applied, crashes=crashes,
        stats=stats, ckpt=ing.Checkpoint(path), names=names, clock=clock)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ingest")
    jax_studies, port_studies = _corpus()
    return _run(JAX, jax_studies, tmp), _run(PORT, port_studies, tmp)


def test_hash_rng_equal():
    for seed, stream, keys in ((0, "pooler", ("jitter", 1)), (7, "pacs-feed", ("dup", 3, 9)),
                               (23, "feed-schedule", ("op", 5))):
        j, p = JAX.events.HashRng(seed, stream), PORT.events.HashRng(seed, stream)
        assert p.u(*keys) == j.u(*keys)
        assert p.choice(list("abcdef"), *keys) == j.choice(list("abcdef"), *keys)


def test_schedules_equal(runs):
    jax, port = runs
    assert [dataclasses.astuple(m) for m in port.schedule] == [
        dataclasses.astuple(m) for m in jax.schedule]
    assert {m.op for m in port.schedule} == {"create", "update", "delete"}


def test_feed_events_equal_through_what_etags_name(runs):
    jax, port = runs
    for run in runs:
        for e in run.feed.events:
            assert not e.etag or run.names[e.etag] == (e.accession, e.version)
    strip = [(e.seq, e.kind, e.accession, e.version) for e in port.feed.events]
    assert strip == [(e.seq, e.kind, e.accession, e.version) for e in jax.feed.events]


def test_applied_ops_equal(runs):
    jax, port = runs
    assert port.crashes == jax.crashes == len(CRASH_POLLS)

    def ops(run):
        return [(op.seq, op.op, op.accession, op.rows,
                 run.names[op.etag] if op.etag else "") for op in run.applied]

    assert ops(port) == ops(jax)
    assert {op.op for op in port.applied} == {"put", "delete"}


def test_checkpoint_outcomes_equal(runs):
    jax, port = runs

    def outcomes(run):
        out = []
        for rec in run.ckpt.outcome_log:
            rec = dict(rec)
            if rec.get("etag"):
                rec["etag"] = ("etag of", run.names[rec["etag"]])
            out.append(rec)
        return out

    assert outcomes(port) == outcomes(jax)
    assert port.ckpt.floor() == jax.ckpt.floor() == port.feed.last_seq
    assert port.ckpt.double_applied == jax.ckpt.double_applied == []
    assert {r["outcome"] for r in port.ckpt.outcome_log} >= {"applied", "dup"}


def test_pooler_and_applier_stats_equal(runs):
    jax, port = runs
    assert port.stats == jax.stats
    assert len(port.stats) == len(CRASH_POLLS) + 1  # each crashed process, then the last
    assert sum(a["redelivered"] for _, a in port.stats) > 0
    assert sum(a["effect_deduped"] for _, a in port.stats) > 0


def test_lake_and_catalog_equal(runs):
    jax, port = runs
    assert port.store.accessions() == jax.store.accessions()
    for acc in port.store.accessions():
        assert port.names[port.feed.fetch(acc)[1]] == jax.names[jax.feed.fetch(acc)[1]]
    for pkg, run in ((JAX, jax), (PORT, port)):
        run.query = pkg.catalog.And(pkg.catalog.In("modality", ["CT"]),
                                    pkg.catalog.Range("study_date", 19000101, 20991231))
    p_sel = port.store.catalog.select(port.query)
    j_sel = jax.store.catalog.select(jax.query)
    assert list(p_sel.accessions) == port.store.accessions()
    for f in {f.name for f in dataclasses.fields(p_sel)} - {"digest"}:
        assert getattr(p_sel, f) == getattr(j_sel, f), f
    # each catalog row carries its store's etag of the accession
    for run in runs:
        assert run.store.catalog.accession_etags() == {
            acc: run.store.study_etag(acc) for acc in run.store.accessions()}
    # the digest differs only through the etags: the port's lake and the
    # JAX lake ingested afresh under the JAX store's etags give one digest
    fresh = {}
    for pkg, run in ((JAX, jax), (PORT, port)):
        fresh[pkg.name] = pkg.make_catalog()
        for acc in run.store.accessions():
            fresh[pkg.name].ingest_study(acc, run.store.get_study(acc),
                                         etag=jax.store.study_etag(acc))
    assert (fresh["repro_torch"].select(port.query).digest
            == fresh["repro"].select(jax.query).digest)


# ------------------------------------------- incremental re-de-identification
REDEID_STUDIES, REDEID_MUTATED = 6, 2


def _redeid(name, tmp):
    """``benchmarks/ingestbench.py::_redeid_row`` on package ``name``."""
    def mod(path):
        return importlib.import_module(f"{name}.{path}")

    core, q = mod("core"), mod("queueing")
    Store = mod("storage.object_store").StudyStore
    Gen = mod("dicom.generator").StudyGenerator
    clock = mod("utils.timing").SimClock()
    gen = Gen(23)
    store = Store("lake", key=b"k")
    mrns = {}
    for i in range(REDEID_STUDIES):
        acc = f"ACC{i:04d}"
        s = gen.gen_study(acc, modality="CT", n_images=1)
        store.put_study(acc, s)
        mrns[acc] = s.mrn
    broker = q.Broker(clock, visibility_timeout=60.0)
    journal = q.Journal(tmp / f"{name}-redeid.jsonl")
    lake = mod("lake.store").ResultLake(max_bytes=1 << 30)
    pipeline = core.DeidPipeline(recompress=False, lake=lake,
                                 **({"device": "cpu"} if name == "repro_torch" else {}))
    service = mod("queueing.server").DeidService(broker, store, journal, result_lake=lake,
                                                 pipeline=pipeline)
    service.register_study("IRB-B", core.TrustMode.POST_IRB)
    dest = Store("researcher")
    workers = []

    def make_worker(wid):
        w = q.DeidWorker(wid, pipeline, store, dest, journal)
        workers.append(w)
        return w

    pool = q.WorkerPool(broker, q.Autoscaler(broker, q.AutoscalerConfig(), clock), make_worker)
    service.submit_cohort("IRB-B", list(mrns), mrns)
    pool.drain()
    cold = sum(w.processed for w in workers)
    for acc in list(mrns)[:REDEID_MUTATED]:
        new = Gen(23 + 99).gen_study(acc, modality="CT", n_images=1)
        new.mrn = mrns[acc]
        store.put_study(acc, new)
    service.submit_cohort("IRB-B", list(mrns), mrns)
    pool.drain()
    journal.close()
    return {
        "cold": cold,
        "re_deids": sum(w.processed for w in workers) - cold,
        "stale_refreshes": service.planner.stats.stale_refreshes,
        "supersessions": journal.supersessions,
        "evicted_stale": sum(w.evicted_stale for w in workers),
        "minutes": clock.now() / 60,
    }


@pytest.fixture(scope="module")
def redeid(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("redeid")
    return _redeid("repro", tmp), _redeid("repro_torch", tmp)


def test_redeid_amplification_exactly_one(redeid):
    _, port = redeid
    assert port["cold"] == REDEID_STUDIES
    assert port["re_deids"] / REDEID_MUTATED == 1.0
    assert port["supersessions"] == REDEID_MUTATED
    assert port["evicted_stale"] == REDEID_MUTATED


def test_redeid_equal_to_jax(redeid):
    jax, port = redeid
    assert port == jax
