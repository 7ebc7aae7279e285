"""Fleet runs of the port beside the JAX package's, and the field-by-field
comparison the fleet tests hold them to.

Both packages' ``FleetConfig`` take the same fields, so one dict of
keyword arguments builds both fleets; the port's runs on ``device="cpu"``.
Pickles name their class's module, so a study's stored size and at-rest
etag differ between the packages by a fixed number of bytes per pickle, and
with them every field that carries a stored size, an etag, a lake key or a
digest over those. :func:`assert_same_fleet` compares each such field
through what it names (the message's study, the accession and source
version, the selection's accessions) and every other field, metric and
delivered instance exactly.
"""
from __future__ import annotations

import pickle
import re
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

import repro.sim as jax_sim
import repro_torch.sim as torch_sim


def corpus(n: int):
    return [f"SIM{i:04d}" for i in range(n)]


def build(mod, path: Path, cfg_kw: Dict, traffic: Optional[Callable] = None,
          chaos: Optional[Callable] = None, device: str = "cpu"):
    """A ``FleetSim`` of package ``mod`` (``repro.sim`` or
    ``repro_torch.sim``): ``traffic(mod)`` and ``chaos(mod)`` build the
    schedules from that package's own classes; the default traffic is one
    cohort of the whole corpus."""
    cfg = mod.FleetConfig(**cfg_kw)
    if traffic is None:
        arrivals = [mod.CohortArrival(t=0.0, study_id="IRB-T",
                                      accessions=tuple(corpus(cfg.n_studies)))]
    else:
        arrivals = traffic(mod)
    kw = {"device": device} if mod is torch_sim else {}
    return mod.FleetSim(cfg, arrivals, path, chaos(mod) if chaos else None, **kw)


def run_both(tmp_path: Path, name: str, cfg_kw: Dict, traffic=None, chaos=None):
    """(port sim, port report, JAX sim, JAX report) of one configuration."""
    ts = build(torch_sim, tmp_path / f"{name}-torch.jsonl", cfg_kw, traffic, chaos)
    tr = ts.run()
    js = build(jax_sim, tmp_path / f"{name}-jax.jsonl", cfg_kw, traffic, chaos)
    jr = js.run()
    return ts, tr, js, jr


def _stored_size(study) -> int:
    return len(pickle.dumps(study, protocol=pickle.HIGHEST_PROTOCOL))


def pickle_delta(ts, js) -> int:
    """Bytes by which each stored study of the port is longer than the same
    study of the JAX package: one fixed number for every source version."""
    assert len(ts._versions) == len(js._versions)
    deltas = {_stored_size(a) - _stored_size(b) for a, b in zip(ts._versions, js._versions)}
    assert len(deltas) == 1, deltas
    (d,) = deltas
    assert d > 0
    return d


def _version(sim, etag):
    """(accession, ingest index) of the source version an etag names."""
    if etag is None:
        return None
    study = sim._etag_study[etag]
    return study.accession, next(i for i, v in enumerate(sim._versions) if v is study)


_FEED_KEY = re.compile(r"^(feed/[^@]+)@[0-9a-f]+(#\d+)$")


def _named_key(key):
    """A feed message's key without its content etag: accession and seq."""
    return _FEED_KEY.sub(r"\1\2", key) if isinstance(key, str) else key


def _assert_sized(a: int, b: int, d: int, copies: int, where: str) -> None:
    """A byte count over ``copies`` stored studies at most: the port's is
    longer by the pickle delta once for each study it counts."""
    diff = a - b
    assert diff % d == 0 and 0 <= diff // d <= copies, (where, a, b, d, copies)
    assert (a == 0) == (b == 0), (where, a, b)


def assert_same_log(ts, js, d: int) -> None:
    assert len(ts.log.records) == len(js.log.records)
    for i, (a, b) in enumerate(zip(ts.log.records, js.log.records)):
        assert a.keys() == b.keys(), (i, a, b)
        for k in a:
            if a["kind"] == "tick" and k == "backlog_bytes":
                _assert_sized(a[k], b[k], d, a["available"] + a["leased"], f"log[{i}]")
            elif a["kind"] == "query" and k == "selection_digest":
                continue  # digest over source etags: the selection is compared below
            else:
                assert a[k] == b[k], (i, k, a, b)
    assert len(ts.query_log) == len(js.query_log)
    for (ta, tsel, tsnap), (ja, jsel, jsnap) in zip(ts.query_log, js.query_log):
        assert repr(ta.query) == repr(ja.query) and ta.t == ja.t
        assert (tsel.accessions, dict(tsel.instance_counts), tsel.total_instances,
                tsel.total_bytes, tsel.blocks_scanned, tsel.blocks_pruned) == (
            jsel.accessions, dict(jsel.instance_counts), jsel.total_instances,
            jsel.total_bytes, jsel.blocks_scanned, jsel.blocks_pruned)
        assert {a: _version(ts, e) for a, e in tsnap.items()} == {
            a: _version(js, e) for a, e in jsnap.items()}


def assert_same_order_logs(ts, js) -> None:
    """Mutation and delivery logs, the source etag mapped to its version."""
    for name in ("mutation_log", "delivery_log"):
        tl, jl = getattr(ts, name), getattr(js, name)
        assert len(tl) == len(jl), name
        for a, b in zip(tl, jl):
            assert {k: v for k, v in a.items() if k != "etag"} == {
                k: v for k, v in b.items() if k != "etag"}, (name, a, b)
            assert _version(ts, a["etag"]) == _version(js, b["etag"]), (name, a, b)


def assert_same_spans(ts, js, d: int) -> None:
    tsp, jsp = ts.tracer.spans(), js.tracer.spans()
    assert len(tsp) == len(jsp)
    traces: Dict[str, str] = {}
    for a, b in zip(tsp, jsp):
        assert (a.name, a.span_id, a.parent_id, a.t0, a.t1, a.seq) == (
            b.name, b.span_id, b.parent_id, b.t0, b.t1, b.seq), (a, b)
        # trace ids hash the work item's key, which for a feed message holds
        # its content etag: the ids must pair one to one
        assert traces.setdefault(a.trace_id, b.trace_id) == b.trace_id, (a, b)
        assert a.attrs.keys() == b.attrs.keys(), (a, b)
        for k in a.attrs:
            if a.name == "broker.publish" and k == "nbytes":
                _assert_sized(a.attrs[k], b.attrs[k], d, 1, a.name)
            elif k == "key":
                assert _named_key(a.attrs[k]) == _named_key(b.attrs[k]), (a, b)
            else:
                assert a.attrs[k] == b.attrs[k], (a.name, k, a.attrs[k], b.attrs[k])
    assert len(set(traces.values())) == len(traces)


def assert_same_outputs(ts, js) -> None:
    """Every researcher-visible instance, decoded: pixels and tags equal."""
    paths = ts.dest.store.list("out/")
    assert paths == js.dest.store.list("out/")
    for p in paths:
        a = pickle.loads(ts.dest.store.get(p))
        b = pickle.loads(js.dest.store.get(p))
        assert dict(a.elements) == dict(b.elements), p
        assert (a.pixels is None) == (b.pixels is None), p
        if a.pixels is not None:
            assert a.pixels.dtype == b.pixels.dtype and np.array_equal(a.pixels, b.pixels), p


def assert_same_fleet(ts, tr, js, jr) -> None:
    """The port's run equals the JAX package's, field by field."""
    assert tr.metrics == jr.metrics
    assert [v.checker for v in tr.violations] == [v.checker for v in jr.violations]
    assert tr.slo == jr.slo
    for k in ("enabled", "records", "by_kind"):
        assert tr.audit.get(k) == jr.audit.get(k), k
    if ts.ledger.enabled:
        assert [r["kind"] for r in ts.ledger.records()] == [
            r["kind"] for r in js.ledger.records()]
    d = pickle_delta(ts, js)
    assert_same_log(ts, js, d)
    assert_same_order_logs(ts, js)
    assert_same_spans(ts, js, d)
    assert_same_outputs(ts, js)
