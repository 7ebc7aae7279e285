"""The port's metadata catalog (``repro_torch.catalog``) against the JAX
package's: the same rows go into ``repro.catalog.StudyCatalog`` and
``repro_torch.catalog.StudyCatalog(device="cpu")``, and both must give the
same snapshot digest and the same ``CohortSelection`` (accessions, instance
counts, bytes, digest, blocks scanned and pruned) for every predicate kind
in both modes; the port's vectorized path must equal its numpy oracle and a
brute-force ``matches_row`` scan; re-ingest and tombstoning must agree."""
import dataclasses

import numpy as np
import pytest

from repro.catalog import StudyCatalog as JaxCatalog
from repro.catalog import query as jax_query
from repro.catalog.columns import rows_from_study as jax_rows_from_study
from repro.dicom.generator import StudyGenerator

from repro_torch.carry import study_from_plain, study_to_plain
from repro_torch.catalog import StudyCatalog, matches_row, rows_from_study
from repro_torch.catalog import query as port_query
from repro_torch.catalog.query import compile_query, eval_oracle, eval_vectorized
from repro_torch.kernels import LAUNCHES

_MODALITIES = ["CT", "MR", "DX", "US", "CR", "PT"]
_PARTS = ["CHEST", "HEAD", "ABDOMEN", "KNEE", ""]
_MAKES = ["GE Medical", "Siemens", "Philips", "Vidar"]
_MODELS = ["Optima CT660", "MAGNETOM Aera", "Epiq 7", "DRX-1"]


def random_rows(rng, n):
    return [
        {
            "modality": str(rng.choice(_MODALITIES)),
            "body_part": str(rng.choice(_PARTS)),
            "manufacturer": str(rng.choice(_MAKES)),
            "model": str(rng.choice(_MODELS)),
            "study_date": 20150000 + int(rng.integers(1, 5)) * 10000
            + int(rng.integers(1, 13)) * 100 + int(rng.integers(1, 29)),
            "bits_stored": int(rng.choice([8, 12, 16])),
            "rows": int(rng.choice([256, 512, 1024])),
            "cols": int(rng.choice([256, 512, 1024])),
            "nbytes": int(rng.integers(1_000, 2_000_000)),
            "burned_in": int(rng.random() < 0.2),
        }
        for _ in range(n)
    ]


def both(rows_by_acc, block_rows=32):
    """The same rows, in the same order, into a JAX and a port catalog."""
    jax_cat = JaxCatalog(block_rows=block_rows)
    port_cat = StudyCatalog(block_rows=block_rows, device="cpu")
    for i, (acc, rows) in enumerate(rows_by_acc.items()):
        for cat in (jax_cat, port_cat):
            cat.ingest_rows(acc, rows, etag=f"etag{i}")
    return jax_cat, port_cat


def corpus(seed=3, n_accessions=24, rows_per=9, sort_dates=False):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_accessions):
        rows = random_rows(rng, rows_per)
        if sort_dates:  # date-clustered blocks, so zone maps prune date ranges
            for r in rows:
                r["study_date"] = 20150101 + i * 100
        out[f"R{i:04d}"] = rows
    return out


# every predicate kind, as (constructor name, args); built in either package
QUERIES = {
    "eq_dict": ("Eq", "modality", "ct"),
    "eq_unknown": ("Eq", "modality", "XX"),
    "eq_int": ("Eq", "bits_stored", 12),
    "in_dict": ("In", "modality", ("CT", "MR", "US")),
    "in_int": ("In", "rows", (256, 1024)),
    "range": ("Range", "study_date", 20160101, 20171231),
    "range_empty": ("Range", "study_date", 20300101, 20301231),
    "contains": ("Contains", "model", "ct"),
    "and": ("And", ("Eq", "modality", "CT"), ("Range", "study_date", 20150101, 20161231)),
    "or": ("Or", ("Eq", "body_part", "HEAD"), ("Contains", "manufacturer", "sie")),
    "not": ("Not", ("Eq", "modality", "DX")),
    "nested": ("And", ("Not", ("In", "modality", ("CT", "PT"))),
               ("Or", ("Range", "rows", 512, 1024), ("Eq", "burned_in", 1)),
               ("Contains", "model", "a")),
}


def _nested(depth):
    spec = ("Range", "study_date", 20150101, 20191231)
    for d in range(depth):
        leaf = ("In", "modality", tuple(_MODALITIES[d % 6:d % 6 + 3]))
        spec = ("And" if d % 2 else "Or", leaf, spec)
    return spec


# long and deep queries (``test_long_and_deep_queries_agree``)
LONG_QUERIES = {
    "and_40": ("And", *[("Range", "study_date", 20150101 + 50 * i, 20191231) if i % 2 else
                        ("In", "modality", tuple(m for m in _MODALITIES if m != _MODALITIES[i % 6]))
                        for i in range(40)]),
    "nested_40": _nested(40),
}


def build(spec, q):
    op, *args = spec
    if op in ("And", "Or"):
        return getattr(q, op)(*(build(s, q) for s in args))
    if op == "Not":
        return q.Not(build(args[0], q))
    return getattr(q, op)(*args)


def assert_same_selection(port_sel, jax_sel):
    assert dataclasses.asdict(port_sel) == dataclasses.asdict(jax_sel)


class TestCatalogParity:
    @pytest.mark.parametrize("sort_dates", [False, True])
    @pytest.mark.parametrize("mode", ["auto", "oracle"])
    @pytest.mark.parametrize("name", sorted(QUERIES))
    def test_same_selection_every_predicate_kind(self, name, mode, sort_dates):
        jax_cat, port_cat = both(corpus(sort_dates=sort_dates))
        assert port_cat.snapshot_digest() == jax_cat.snapshot_digest()
        spec = QUERIES[name]
        launches = LAUNCHES["bitmap"]
        port_sel = port_cat.select(build(spec, port_query), mode=mode)
        jax_sel = jax_cat.select(build(spec, jax_query), mode=mode)
        assert_same_selection(port_sel, jax_sel)
        assert LAUNCHES["bitmap"] == launches  # device="cpu" launches nothing
        assert dataclasses.asdict(port_cat.stats) == dataclasses.asdict(jax_cat.stats)

    def test_date_sorted_ranges_prune(self):
        jax_cat, port_cat = both(corpus(sort_dates=True))
        q = ("Range", "study_date", 20150101, 20150301)
        sel = port_cat.select(build(q, port_query))
        assert sel.blocks_pruned > 0 and sel.blocks_scanned > 0
        assert_same_selection(sel, jax_cat.select(build(q, jax_query)))

    @pytest.mark.parametrize("name", sorted(LONG_QUERIES))
    def test_long_and_deep_queries_agree(self, name):
        """A 40-child And (81 program ops) and a 40-deep And/Or nesting (41
        values deep as compiled), which the card's bitmap wrapper must
        schedule (``kernels/bitmap/ops.py::schedule_program``): the CPU
        selection must equal the JAX catalog's."""
        jax_cat, port_cat = both(corpus(seed=9))
        spec = LONG_QUERIES[name]
        port_sel = port_cat.select(build(spec, port_query))
        assert_same_selection(port_sel, jax_cat.select(build(spec, jax_query)))
        assert port_sel.total_instances > 0

    @pytest.mark.parametrize("prune", [True, False])
    def test_unpruned_scan_agrees(self, prune):
        jax_cat, port_cat = both(corpus(seed=8))
        q = QUERIES["nested"]
        assert_same_selection(port_cat.select(build(q, port_query), prune=prune),
                              jax_cat.select(build(q, jax_query), prune=prune))


class TestEvaluators:
    @pytest.mark.parametrize("name", sorted(QUERIES))
    def test_vectorized_equals_oracle_equals_brute_force(self, name):
        rows_by_acc = corpus(seed=11, n_accessions=7, rows_per=13)
        _, cat = both(rows_by_acc, block_rows=16)
        pred = build(QUERIES[name], port_query)
        rows = [r for rs in rows_by_acc.values() for r in rs]
        compiled = compile_query(pred, cat.dicts)
        arrays = {c: np.concatenate([b.cols[c] for b in cat._all_blocks()]) for c in compiled.cols}
        valid = np.concatenate([b.valid for b in cat._all_blocks()])
        brute = np.array([matches_row(pred, r) for r in rows])
        oracle = eval_oracle(compiled, arrays, valid)
        vec = eval_vectorized(compiled, arrays, valid, device="cpu")
        np.testing.assert_array_equal(oracle, brute)
        np.testing.assert_array_equal(vec, brute)

    def test_empty_catalog(self):
        compiled = compile_query(port_query.Eq("modality", "CT"), StudyCatalog(device="cpu").dicts)
        assert eval_vectorized(compiled, {"modality": np.zeros(0, np.int32)},
                               np.zeros(0, bool), device="cpu").shape == (0,)
        sel = StudyCatalog(device="cpu").select(port_query.Eq("modality", "CT"))
        jsel = JaxCatalog().select(jax_query.Eq("modality", "CT"))
        assert_same_selection(sel, jsel)


class TestReingest:
    def test_reingest_tombstones_and_digests_agree(self):
        rng = np.random.default_rng(21)
        rows_by_acc = corpus(seed=21, n_accessions=10, rows_per=6)
        jax_cat, port_cat = both(rows_by_acc, block_rows=8)
        new_rows = random_rows(rng, 4)
        for cat in (jax_cat, port_cat):
            cat.ingest_rows("R0003", new_rows, etag="etag3b")   # re-acquisition
            cat.remove_study("R0005")                           # feed delete
            cat.remove_study("NOPE")
        assert port_cat.snapshot_digest() == jax_cat.snapshot_digest()
        assert port_cat.accession_etags() == jax_cat.accession_etags()
        assert port_cat.n_rows() == jax_cat.n_rows() == 10 * 6 + 4
        assert port_cat.stats.tombstoned == jax_cat.stats.tombstoned == 12
        for name in ("not", "range", "in_dict"):
            for mode in ("auto", "oracle"):
                sel = port_cat.select(build(QUERIES[name], port_query), mode=mode)
                assert "R0005" not in sel.accessions
                assert_same_selection(sel, jax_cat.select(build(QUERIES[name], jax_query), mode=mode))
        sel = port_cat.select(port_query.Not(port_query.Eq("modality", "ZZ")))
        assert sel.instance_counts["R0003"] == 4   # only the new version's rows


class TestStudyRows:
    def test_rows_from_carried_studies_equal(self):
        gen = StudyGenerator(seed=77)
        studies = [gen.gen_study("ROWS-CT", modality="CT", n_images=3),
                   gen.gen_study("ROWS-US", modality="US", n_images=2),
                   gen.gen_study("ROWS-UNK", device=gen.unknown_device("rows", "CT"), n_images=2)]
        jax_cat, port_cat = JaxCatalog(), StudyCatalog(device="cpu")
        for s in studies:
            port_study = study_from_plain(study_to_plain(s))
            assert rows_from_study(port_study) == jax_rows_from_study(s)
            jax_cat.ingest_study(s.accession, s, etag="e")
            port_cat.ingest_study(port_study.accession, port_study, etag="e")
        assert port_cat.snapshot_digest() == jax_cat.snapshot_digest()
        q = ("Or", ("Eq", "burned_in_detected", 1), ("Eq", "modality", "US"))
        assert_same_selection(port_cat.select(build(q, port_query)),
                              jax_cat.select(build(q, jax_query)))


def test_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        assert StudyCatalog().device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            StudyCatalog()
