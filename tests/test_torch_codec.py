"""The port's host modules are copies of the JAX package's: the RJLS codec
must be byte-identical, the study generator must give the same tags and
pixels for the same seed, and a study carried across as plain values must
arrive unchanged."""
import numpy as np
import pytest

from repro.core import scripts as jax_scripts
from repro.core.rules import script_sha as jax_script_sha
from repro.dicom import codec as jax_codec
from repro.dicom.devices import registry as jax_registry
from repro.dicom.generator import StudyGenerator as JaxGenerator

from repro_torch.carry import study_from_plain, study_to_plain
from repro_torch.core import scripts
from repro_torch.core.rules import script_sha
from repro_torch.dicom import codec
from repro_torch.dicom.devices import registry
from repro_torch.dicom.generator import StudyGenerator


def _planes(rng):
    yield rng.integers(0, 256, size=(37, 53)).astype(np.uint8)
    yield rng.integers(0, 65536, size=(40, 61)).astype(np.uint16)  # full range
    yield (rng.normal(2048, 600, size=(48, 32))).clip(0, 4095).astype(np.uint16)
    yield np.zeros((16, 16), np.uint8)  # k = 0
    yield np.full((12, 20), 1 << 15, np.uint16)


class TestCodecCopy:
    @pytest.mark.parametrize("sv", list(range(1, 8)))
    def test_encode_plan_pack_decode_byte_identical(self, rng, sv):
        for img in _planes(rng):
            res = codec.residuals(img, sv)
            np.testing.assert_array_equal(res, jax_codec.residuals(img, sv))
            plan, jplan = codec.rice_plan(res), jax_codec.rice_plan(res)
            assert plan.k == jplan.k
            np.testing.assert_array_equal(plan.lens, jplan.lens)
            np.testing.assert_array_equal(plan.offs, jplan.offs)
            assert codec.rice_pack(plan) == jax_codec.rice_pack(jplan)
            stream = codec.encode(img, sv)
            assert stream == jax_codec.encode(img, sv)
            np.testing.assert_array_equal(codec.decode(stream), img)

    def test_escape_stream_identical(self, rng):
        res = np.zeros(4096, np.int64)
        hot = rng.choice(4096, size=37, replace=False)
        res[hot] = rng.integers(-(2**20), 2**20, size=37)
        assert codec.rice_plan(res).esc.sum() > 0
        assert codec.rice_encode(res) == jax_codec.rice_encode(res)
        payload, k = codec.rice_encode(res)
        np.testing.assert_array_equal(codec.rice_decode(payload, k, res.size), res)

    def test_batch_residuals_and_header(self, rng):
        imgs = rng.integers(0, 65536, size=(3, 21, 17)).astype(np.uint16)
        np.testing.assert_array_equal(codec.residuals_batch(imgs, 5),
                                      jax_codec.residuals_batch(imgs, 5))
        assert codec.pack_header(3, 4, 16, 2, 7, 99) == jax_codec.pack_header(3, 4, 16, 2, 7, 99)
        assert codec._QMAX == jax_codec._QMAX
        assert codec._rice_k_from_sum(2**40, 5_120_000) == jax_codec._rice_k_from_sum(
            2**40, 5_120_000)


def _assert_same_study(a, b):
    assert (a.accession, a.mrn, a.patient_name, a.study_uid, a.study_date, a.modality,
            a.body_part) == (b.accession, b.mrn, b.patient_name, b.study_uid, b.study_date,
                             b.modality, b.body_part)
    assert a.device.id() == b.device.id()
    assert {k: list(v) for k, v in a.phi_rects.items()} == {
        k: list(v) for k, v in b.phi_rects.items()}
    assert len(a.datasets) == len(b.datasets)
    for x, y in zip(a.datasets, b.datasets):
        assert x.elements == y.elements
        assert x.private == y.private
        assert x.encapsulated == y.encapsulated
        if x.pixels is None:
            assert y.pixels is None
        else:
            assert x.pixels.dtype == y.pixels.dtype
            np.testing.assert_array_equal(x.pixels, y.pixels)


class TestGeneratorCopy:
    @pytest.mark.parametrize("modality,n,problem", [
        ("CT", 3, "pdf"), ("US", 2, None), ("DX", 1, "burned_in_yes")])
    def test_same_seed_same_study(self, modality, n, problem):
        jax_study = JaxGenerator(seed=77).gen_study(
            f"GEN-{modality}", modality=modality, n_images=n, problem=problem)
        port_study = StudyGenerator(seed=77).gen_study(
            f"GEN-{modality}", modality=modality, n_images=n, problem=problem)
        _assert_same_study(port_study, jax_study)

    def test_carry_round_trip(self, gen):
        s = gen.gen_study("CARRY-US", modality="US", n_images=2, problem="sr")
        carried = study_from_plain(study_to_plain(s))
        _assert_same_study(carried, s)
        assert type(carried).__module__ == "repro_torch.dicom.generator"
        assert type(carried.datasets[0]).__module__ == "repro_torch.dicom.dataset"
        # copies, not views: editing the carried study leaves the source alone
        carried.datasets[0].pixels[0, 0] ^= 1
        assert carried.datasets[0].pixels[0, 0] != s.datasets[0].pixels[0, 0]

    def test_scripts_and_registry_identical(self):
        for name in ("DEFAULT_FILTER_SCRIPT", "DEFAULT_ANONYMIZER_SCRIPT",
                     "DEFAULT_SCRUB_SCRIPT"):
            text = getattr(scripts, name)
            assert text == getattr(jax_scripts, name)
            assert script_sha(text) == jax_script_sha(text)
        assert registry().table2_stats() == jax_registry().table2_stats()
        assert [k.id() for k in registry().all_us_variants()] == [
            k.id() for k in jax_registry().all_us_variants()]
