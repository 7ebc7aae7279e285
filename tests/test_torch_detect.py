"""The port's burned-in-PHI detector path against the JAX package's, exactly:
``DeidPipeline(detector_policy=...)`` in modes ``registry_first``, ``union``
and ``off`` on studies made by the JAX generator and carried across as
plain values.

Compared, with the kernel path forced and not forced: manifests (compressed
sizes included), delivered tags and pixels, every ``DetectionReport``, the
``detect_stats`` counters, the ledger appends (``detector_decision`` and
``deid_execute``), the ruleset fingerprint (all of it but ``config_sha``,
which names the blank function's module), trace digests, and the
executor's ``detect_row_hits`` (profiles, padded shapes, dispatch counts).
On the CPU ``use_kernel=True`` runs the textdetect op's plain PyTorch
version; ``tests/test_torch_gpu.py`` runs the CUDA kernel on the card.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import DeidPipeline as JaxPipeline
from repro.core import PseudonymService as JaxPseudonyms
from repro.core import TrustMode as JaxTrust
from repro.core import build_request as jax_build_request
from repro.core.batch import BatchedDeidExecutor as JaxExecutor
from repro.detect import DetectorPolicy as JaxPolicy
from repro.dicom.devices import DeviceKey as JaxDeviceKey
from repro.dicom.generator import StudyGenerator
from repro.obs.trace import Tracer as JaxTracer
from repro.utils.timing import SimClock

from repro_torch.carry import study_from_plain, study_to_plain
from repro_torch.core import DeidPipeline, PseudonymService, TrustMode, build_request
from repro_torch.core.batch import BatchedDeidExecutor
from repro_torch.detect import DetectorPolicy
from repro_torch.detect.report import DetectStats
from repro_torch.obs.trace import Tracer

KEY = b"d" * 32


class RecordingLedger:
    """Stands in for the audit ledger: records every append."""

    def __init__(self):
        self.records = []

    def append(self, kind, **fields):
        self.records.append((kind, fields))


@pytest.fixture(scope="module")
def studies():
    gen = StudyGenerator(seed=7)
    return {
        "unknown-CT": gen.gen_study("DET-UCT", device=gen.unknown_device("DET-UCT", "CT"),
                                    n_images=3),
        "unknown-DX": gen.gen_study("DET-UDX", device=gen.unknown_device("DET-UDX", "DX"),
                                    n_images=2),
        "known-CT": gen.gen_study("DET-KCT", device=JaxDeviceKey("CT", "GE", "Discovery", 512, 512),
                                  n_images=2),
        "known-US": gen.gen_study("DET-KUS", modality="US", n_images=2),
    }


def _run(make_pipe, study, *, port: bool, use_kernel=None, serial=False, **kw):
    """Run one pipeline over one study; returns everything compared."""
    ledger = RecordingLedger()
    pipe = make_pipe(ledger=ledger, **kw)
    if pipe.executor is not None:
        pipe.executor.use_kernel = use_kernel
    reports = []
    scrub_study = pipe.scrub.scrub_study

    def capture(datasets, executor):
        slots = scrub_study(datasets, executor)
        reports.extend(None if r is None or r.detection is None
                       else dataclasses.asdict(r.detection) for r, _ in slots)
        return slots

    pipe.scrub.scrub_study = capture
    if port:
        study = study_from_plain(study_to_plain(study))
        pseudo = PseudonymService("IRB-D", TrustMode.POST_IRB, key=KEY)
        req = build_request(pseudo, study.accession, study.mrn)
    else:
        req = jax_build_request(JaxPseudonyms("IRB-D", JaxTrust.POST_IRB, key=KEY),
                                study.accession, study.mrn)
    if serial:
        delivered, manifest = pipe.process_study_serial(study, req, "w0")
        # the serial path resolves rects per instance through __call__
        reports = None
    else:
        delivered, manifest = pipe.process_study(study, req, "w0")
    stats = {f: getattr(pipe.scrub.detect_stats, f) for f in DetectStats._FIELDS}
    fingerprint = pipe.ruleset_fingerprint()
    for kind, fields in ledger.records:
        if kind == "deid_execute":
            assert fields.pop("ruleset") == fingerprint.digest
    # config_sha folds in the blank_fn's module path (repro.core.scrub or
    # repro_torch.core.scrub), so it differs between the packages by design
    shas = {k: v for k, v in dataclasses.asdict(fingerprint).items() if k != "config_sha"}
    return {
        "manifest": manifest.to_json(),
        "delivered": [(d.elements, d.private, d.pixels.dtype.str, d.pixels.tobytes())
                      for d in delivered],
        "reports": reports,
        "stats": stats,
        "ledger": ledger.records,
        "fingerprint": shas,
        "executor": pipe.executor,
        "datasets": delivered,
    }


def _jax_pipe(mode, **kw):
    policy = None if mode is None else JaxPolicy(mode=mode)
    return lambda **k: JaxPipeline(detector_policy=policy, **kw, **k)


def _port_pipe(mode, **kw):
    policy = None if mode is None else DetectorPolicy(mode=mode)
    return lambda **k: DeidPipeline(detector_policy=policy, device="cpu", **kw, **k)


def _assert_same(port, ref):
    for key in ("manifest", "delivered", "reports", "stats", "ledger", "fingerprint"):
        assert port[key] == ref[key], key


CASES = [
    ("registry_first", "unknown-CT"),
    ("registry_first", "unknown-DX"),
    ("union", "known-CT"),
    ("union", "known-US"),
]


class TestPipelineParity:
    @pytest.mark.parametrize("use_kernel", [None, True])
    @pytest.mark.parametrize("mode,name", CASES)
    def test_detector_path_equals_jax(self, studies, mode, name, use_kernel):
        study = studies[name]
        ref = _run(_jax_pipe(mode), study, port=False)
        got = _run(_port_pipe(mode), study, port=True, use_kernel=use_kernel)
        _assert_same(got, ref)
        ran = [r for r in got["reports"] if r["detector_ran"]]
        assert len(ran) == len(study.datasets)  # every instance was scanned
        assert any(r["bands"] for r in ran), "a burned-in instance must be detected"
        assert got["stats"]["detector_runs"] == len(study.datasets)
        assert sum(kind == "detector_decision" for kind, _ in got["ledger"]) == len(study.datasets)
        ex = got["executor"]
        assert ex.stats.detect_instances == len(study.datasets)
        if use_kernel:
            assert any(s[-1] == "detect" for s in ex.stats.padded_shapes)

    def test_unknown_device_text_is_blanked(self, studies):
        study = studies["unknown-CT"]
        got = _run(_port_pipe("registry_first", recompress=False), study, port=True,
                   use_kernel=True)
        assert study.phi_rects
        by_uid = dict(zip([ds["SOPInstanceUID"] for ds in study.datasets], got["datasets"]))
        for uid, rects in study.phi_rects.items():
            for x, y, w, h in rects:
                assert int(by_uid[uid].pixels[y : y + h, x : x + w].max()) == 0

    @pytest.mark.parametrize("name", ["unknown-CT", "known-US"])
    def test_off_equals_no_policy(self, studies, name):
        study = studies[name]
        off = _run(_port_pipe("off"), study, port=True)
        none = _run(_port_pipe(None), study, port=True)
        for key in ("manifest", "delivered", "stats", "ledger", "fingerprint"):
            assert off[key] == none[key], key
        assert off["reports"] == [None] * len(study.datasets)
        assert off["executor"].stats.detect_dispatches == 0
        _assert_same(off, _run(_jax_pipe("off"), study, port=False))

    @pytest.mark.parametrize("mode,name", [("registry_first", "unknown-CT"), ("union", "known-US")])
    def test_serial_equals_batched(self, studies, mode, name):
        study = studies[name]
        batched = _run(_port_pipe(mode), study, port=True, use_kernel=True)
        serial = _run(_port_pipe(mode, batched=False), study, port=True, serial=True)
        for key in ("manifest", "delivered", "stats", "fingerprint"):
            assert serial[key] == batched[key], key
        # the serial path appends no deid_execute record, only the decisions
        assert serial["ledger"] == [r for r in batched["ledger"] if r[0] == "detector_decision"]
        assert batched["executor"].stats.detect_dispatches >= 1
        ref = _run(_jax_pipe(mode, batched=False), study, port=False, serial=True)
        _assert_same(serial, ref)

    def test_fingerprint_follows_policy(self):
        prints = {m: DeidPipeline(detector_policy=None if m is None else DetectorPolicy(mode=m),
                                  device="cpu").ruleset_fingerprint()
                  for m in (None, "off", "registry_first", "union")}
        assert prints["off"] == prints[None]
        assert len({fp.digest for fp in prints.values()}) == 3
        for m, fp in prints.items():
            policy = None if m is None else JaxPolicy(mode=m)
            ref = JaxPipeline(detector_policy=policy).ruleset_fingerprint()
            assert fp.detector_sha == ref.detector_sha
            assert (m in (None, "off")) == (fp.detector_sha == "")

    @pytest.mark.parametrize("use_kernel", [None, True])
    def test_trace_digest_equals_jax(self, studies, use_kernel):
        study = studies["unknown-CT"]
        jt, pt = JaxTracer(SimClock()), Tracer(SimClock())
        _run(_jax_pipe("registry_first", tracer=jt, recompress=False), study, port=False,
             use_kernel=use_kernel)
        _run(_port_pipe("registry_first", tracer=pt, recompress=False), study, port=True,
             use_kernel=use_kernel)
        spans = pt.spans("kernel.detect_dispatch")
        assert spans and {sp.attrs["path"] for sp in spans} == {
            "textdetect" if use_kernel else "oracle"}
        assert pt.digest() == jt.digest()


def _entries(rng):
    """Two shapes, two dtypes, two thresholds: four buckets, one of them
    over max_batch."""
    out = []
    for i in range(11):
        dtype = np.uint16 if i % 3 else np.uint8
        top = 4095 if dtype == np.uint16 else 255
        px = (rng.random((40, 150) if i % 2 else (64, 128)) * top * 0.5).astype(dtype)
        px[3:9, ::3] = top
        out.append((px, top * 0.6 if i < 8 else top * 0.5))
    return out


class TestDetectRowHits:
    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_equals_jax_executor(self, rng, use_kernel):
        entries = _entries(rng)
        jt, pt = JaxTracer(SimClock()), Tracer(SimClock())
        ex = BatchedDeidExecutor(max_batch=2, use_kernel=use_kernel, tracer=pt, device="cpu")
        ref = JaxExecutor(max_batch=2, use_kernel=use_kernel, tracer=jt)
        got, want = ex.detect_row_hits(entries), ref.detect_row_hits(entries)
        assert len(got) == len(entries)
        for g, w, (px, _) in zip(got, want, entries):
            assert g.dtype == np.int32 and g.shape == (px.shape[0],)
            np.testing.assert_array_equal(g, w)
        assert ex.stats.padded_shapes == ref.stats.padded_shapes
        assert ex.stats.detect_dispatches == ref.stats.detect_dispatches > 4
        assert ex.stats.detect_instances == ref.stats.detect_instances == len(entries)
        assert pt.digest() == jt.digest()

    def test_non_finite_threshold_rejected(self):
        px = np.zeros((32, 128), np.uint8)
        for ex in (BatchedDeidExecutor(device="cpu"), JaxExecutor()):
            with pytest.raises(ValueError, match="finite"):
                ex.detect_row_hits([(px, 10.0), (px, float("nan"))])
