"""The port's DeidPipeline against ``repro.core.DeidPipeline`` on small CT,
US and DX studies made by the JAX package's generator and carried across as
plain values: identical manifests (compressed sizes included), delivered
tags and pixels, with the kernel path forced and not forced."""
import numpy as np
import pytest
import torch

from repro.core import DeidPipeline as JaxPipeline
from repro.core import PseudonymService as JaxPseudonyms
from repro.core import TrustMode as JaxTrust
from repro.core import build_request as jax_build_request
from repro.obs.trace import Tracer as JaxTracer
from repro.utils.timing import SimClock

from repro_torch.carry import study_from_plain, study_to_plain
from repro_torch.core import DeidPipeline, Outcome, PseudonymService, TrustMode, build_request
from repro_torch.detect.policy import DetectorPolicy
from repro_torch.dicom.devices import DeviceKey
from repro_torch.kernels.scrub.ops import make_blank_fn
from repro_torch.obs.trace import Tracer

KEY = b"p" * 32


def _both(study):
    jax_req = jax_build_request(JaxPseudonyms("IRB-T", JaxTrust.POST_IRB, key=KEY),
                                study.accession, study.mrn)
    port_study = study_from_plain(study_to_plain(study))
    port_req = build_request(PseudonymService("IRB-T", TrustMode.POST_IRB, key=KEY),
                             port_study.accession, port_study.mrn)
    return port_study, port_req, jax_req


def _assert_same(port_out, jax_out):
    (p_delivered, p_manifest), (j_delivered, j_manifest) = port_out, jax_out
    assert p_manifest.to_json() == j_manifest.to_json()
    assert len(p_delivered) == len(j_delivered)
    for a, b in zip(p_delivered, j_delivered):
        assert a.elements == b.elements and a.private == b.private
        if b.pixels is None:
            assert a.pixels is None
        else:
            assert a.pixels.dtype == b.pixels.dtype
            np.testing.assert_array_equal(a.pixels, b.pixels)


STUDIES = [
    ("CT", dict(modality="CT", n_images=18, problem="pdf")),
    ("US", dict(modality="US", n_images=3)),
    ("DX", dict(device=DeviceKey("DX", "GE", "Definium", 2500, 2048), n_images=1)),
]


@pytest.fixture(scope="module")
def studies():
    from repro.dicom.generator import StudyGenerator

    gen = StudyGenerator(seed=4321)
    return {name: gen.gen_study(f"PIPE-{name}", **kw) for name, kw in STUDIES}


class TestPipelineParity:
    @pytest.mark.parametrize("use_kernel", [None, True])
    @pytest.mark.parametrize("recompress", [True, False])
    @pytest.mark.parametrize("name", [n for n, _ in STUDIES])
    def test_same_manifest_pixels_and_sizes(self, studies, name, recompress, use_kernel):
        study = studies[name]
        port_study, port_req, jax_req = _both(study)
        jax_out = JaxPipeline(recompress=recompress).process_study(study, jax_req, "w0")
        pipe = DeidPipeline(recompress=recompress, device="cpu")
        pipe.executor.use_kernel = use_kernel
        _assert_same(pipe.process_study(port_study, port_req, "w0"), jax_out)
        assert pipe.executor.stats.instances > 0
        if use_kernel:
            assert pipe.executor.stats.padded_shapes  # the device-path code ran
        if recompress:
            assert all(e.compressed_bytes > 0 for e in jax_out[1].entries
                       if e.outcome.value == "anonymized")

    def test_serial_path_equals_jax_serial(self, studies):
        study = studies["US"]
        port_study, port_req, jax_req = _both(study)
        jax_out = JaxPipeline(batched=False).process_study_serial(study, jax_req, "w0")
        pipe = DeidPipeline(batched=False, device="cpu")
        assert pipe.executor is None
        _assert_same(pipe.process_study_serial(port_study, port_req, "w0"), jax_out)
        _assert_same(pipe.process_study(port_study, port_req, "w0"), jax_out)

    def test_trace_digest_equals_jax(self, studies):
        study = studies["CT"]
        port_study, port_req, jax_req = _both(study)
        jt, pt = JaxTracer(SimClock()), Tracer(SimClock())
        JaxPipeline(tracer=jt).run_study(study, jax_req, "w0")
        DeidPipeline(tracer=pt, device="cpu").run_study(port_study, port_req, "w0")
        assert pt.spans("kernel.entropy_code") and pt.spans("pipeline.run_study")
        assert pt.digest() == jt.digest()

    def test_kernel_blank_fn_batches_and_matches(self, studies):
        study = studies["US"]
        port_study, port_req, jax_req = _both(study)
        jax_out = JaxPipeline().process_study(study, jax_req)
        pipe = DeidPipeline(blank_fn=make_blank_fn(device="cpu"), device="cpu")
        _assert_same(pipe.process_study(port_study, port_req), jax_out)
        assert pipe.executor.stats.instances > 0


class TestPipelineContracts:
    def test_default_device_is_cuda_or_raises(self):
        if torch.cuda.is_available():
            assert DeidPipeline().device == torch.device("cuda:0")
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                DeidPipeline()

    def test_lake_refused_detector_scans(self, gen):
        """A result lake too small for any instance record refuses every
        write, as the JAX package's does, and the study is still delivered
        cold; an enabled detector policy builds and scans an unknown
        device's instances."""
        from repro.lake import ResultLake as JaxLake

        from repro_torch.lake import ResultLake

        s = gen.gen_study("PIPE-UNK", device=gen.unknown_device("PIPE-UNK", "CT"), n_images=2)
        port_study, port_req, jax_req = _both(s)
        lake, jax_lake = ResultLake(max_bytes=64), JaxLake(max_bytes=64)
        pipe = DeidPipeline(detector_policy=DetectorPolicy(), recompress=False, lake=lake,
                            device="cpu")
        result = pipe.run_study(port_study, port_req)
        jax_result = JaxPipeline(lake=jax_lake).run_study(s, jax_req)
        assert (result.cache_hits, result.cache_misses) == (0, 2)
        assert lake.stats.oversize_rejects == jax_lake.stats.oversize_rejects == 2
        assert len(lake) == 0 and len(result.delivered) == 2
        assert pipe.scrub.detect_stats.detector_runs == 2
        assert pipe.executor.stats.detect_instances == 2
        # a disabled policy is the registry-only behaviour, as in the JAX package
        off = DeidPipeline(detector_policy=DetectorPolicy(mode="off"), device="cpu")
        off.process_study(port_study, port_req)
        assert off.scrub.detect_stats.detector_runs == 0

    def test_us_fail_closed_and_unknown_device_counted(self, gen):
        from repro.core import DeidPipeline as JP

        s = gen.gen_study("PIPE-USX", device=DeviceKey("US", "UnknownMake", "Mystery-1", 480, 640),
                          n_images=2)
        port_study, port_req, jax_req = _both(s)
        pipe = DeidPipeline(filter_script="# empty\n", device="cpu")
        outs, manifest = pipe.process_study(port_study, port_req)
        assert outs == []
        assert all(e.outcome is Outcome.FAILED for e in manifest.entries)
        assert pipe.scrub.detect_stats.unknown_lookups == 2
        _assert_same((outs, manifest),
                     JP(filter_script="# empty\n").process_study(s, jax_req))
