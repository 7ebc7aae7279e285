"""The port's burned-in-text audit (``repro_torch.kernels.phi_detect``)
against the JAX package's, exactly.

On the CPU the port's ``edge_density`` runs the kernel's plain PyTorch
version; the JAX op runs the Pallas kernel in interpret mode. Densities must
equal the JAX oracle's as float32 arrays (``np.array_equal``), and flags as
booleans — with a bright last column before the zero padding (the pad edge
counts) and every pixel type. They equal the JAX Pallas kernel's too where
the tile area is a power of two, the default (32, 128) included. At any
other area XLA turns the kernel's division by the constant area into a
product with its reciprocal: the test pins both formulas exactly, and the
two lie one ulp apart at most.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dicom.dataset import DicomDataset as JaxDataset
from repro.kernels.phi_detect import ops as jax_ops
from repro.kernels.phi_detect.ref import edge_density_ref as jax_edge_density_ref

from repro_torch.carry import study_from_plain, study_to_plain
from repro_torch.core.scrub import numpy_blank
from repro_torch.dicom.dataset import DicomDataset
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.phi_detect import cases as phi_cases
from repro_torch.kernels.phi_detect import ops
from repro_torch.kernels.phi_detect.ref import edge_density_ref, phi_flags_ref
from repro_torch.kernels.textdetect.ref import pad_to_tiles_np


def _strokes(rng, shape, dtype):
    """Smooth anatomy, a stroke band, and a bright last column (whose pair
    with the first padding column is a strong edge)."""
    top = 1.0 if dtype == np.float32 else float(np.iinfo(dtype).max)
    imgs = rng.random(shape) * top * 0.3
    imgs[:, 10:30, ::2] = top
    imgs[:, :, -1] = top
    return imgs.astype(dtype)


def _thresh(dtype):
    return (1.0 if dtype == np.float32 else float(np.iinfo(dtype).max)) * 0.25


class TestEdgeDensity:
    @pytest.mark.parametrize("tile", [(32, 128), (24, 100), (16, 64)])
    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
    @pytest.mark.parametrize("shape", [(1, 64, 128), (2, 96, 256), (2, 70, 201), (1, 33, 130)])
    def test_equals_jax_kernel_and_oracle(self, rng, shape, dtype, tile):
        imgs = _strokes(rng, shape, dtype)
        thresh = _thresh(dtype)
        got = ops.edge_density(torch.from_numpy(imgs), thresh=thresh, tile=tile)
        assert got.dtype == torch.float32
        got = got.numpy()
        want_k = np.asarray(jax_ops.edge_density(imgs, thresh=thresh, tile=tile, interpret=True))
        want_r = np.asarray(jax_edge_density_ref(jnp.asarray(pad_to_tiles_np(imgs, tile)),
                                                 thresh, tile))
        np.testing.assert_array_equal(got, want_r)
        np.testing.assert_array_equal(edge_density_ref(torch.from_numpy(imgs), thresh, tile).numpy(),
                                      want_r)
        area = np.float32(tile[0] * tile[1])
        counts = np.rint(got.astype(np.float64) * float(area)).astype(np.float32)
        np.testing.assert_array_equal(got, counts / area)  # one IEEE float32 division
        if tile[0] * tile[1] & (tile[0] * tile[1] - 1) == 0:
            np.testing.assert_array_equal(got, want_k)
        else:
            # XLA compiles the Pallas kernel's division by the constant area
            # into a product with its float32 reciprocal, one ulp off the
            # quotient that the JAX oracle and the port compute
            np.testing.assert_array_equal(want_k, counts * (np.float32(1) / area))
            np.testing.assert_array_max_ulp(got, want_k, maxulp=1)

    @pytest.mark.parametrize("dtype", phi_cases.DTYPES)
    @pytest.mark.parametrize("shape", phi_cases.SHAPES)
    @pytest.mark.parametrize("offset", phi_cases.OFFSETS)
    def test_misaligned_view_and_ragged_edges_equal_jax(self, rng, dtype, shape, offset):
        """The layouts the CUDA kernel's 16-byte chunks meet
        (``kernels/phi_detect/cases.py``), on the plain version: a view
        starting off a 16-byte boundary, ragged right and bottom edges,
        tile widths that are no vector multiple, every pixel type (negative
        values in the signed ones), the float32 threshold straddle and
        thresh 0. Exact against the JAX oracle, and against the Pallas
        kernel at the (32, 128) tile."""
        N, H, W = shape
        base = phi_cases.planes(rng, dtype, shape)
        imgs, view = base[offset:offset + N], torch.from_numpy(base)[offset:offset + N]
        for tile in phi_cases.TILES:
            for thresh in phi_cases.threshes(dtype):
                got = ops.edge_density(view, thresh=thresh, tile=tile).numpy()
                want = np.asarray(jax_edge_density_ref(jnp.asarray(pad_to_tiles_np(imgs, tile)),
                                                       thresh, tile))
                np.testing.assert_array_equal(got, want)
        got = ops.edge_density(view, thresh=2457.0001).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jax_ops.edge_density(imgs, thresh=2457.0001, interpret=True)))

    def test_pad_edge_counts(self):
        """A bright last column of a ragged frame is a strong edge against
        the first zero of the padding, in the reference and here; inside a
        tile-aligned frame it has no right neighbour in its tile."""
        img = np.zeros((1, 32, 100), np.uint16)
        img[0, :, -1] = 4095
        got = ops.edge_density(torch.from_numpy(img), thresh=1000.0).numpy()
        # per row: the step up into column 99 and the step down past it
        assert got[0, 0, 0] == np.float32(2 * 32) / np.float32(32 * 128)
        np.testing.assert_array_equal(
            got, np.asarray(jax_ops.edge_density(img, thresh=1000.0, interpret=True)))
        aligned = np.zeros((1, 32, 128), np.uint16)
        aligned[0, :, -1] = 4095
        assert ops.edge_density(torch.from_numpy(aligned), thresh=1000.0).numpy()[0, 0, 0] == \
            np.float32(32) / np.float32(32 * 128)

    def test_uint16_full_range_by_value(self):
        img = np.zeros((1, 32, 128), np.uint16)
        img[0, :, 1::2] = 65535  # a signed view would read -1: |-1 - 0| < thresh
        got = ops.edge_density(torch.from_numpy(img), thresh=30000.0).numpy()
        assert got[0, 0, 0] == np.float32(32 * 127) / np.float32(32 * 128)
        np.testing.assert_array_equal(
            got, np.asarray(jax_ops.edge_density(img, thresh=30000.0, interpret=True)))

    def test_default_threshold_follows_dtype(self):
        assert ops.full_scale(np.uint16) == jax_ops.full_scale(np.uint16) == 65535.0
        assert ops.full_scale(np.uint8) == 255.0 and ops.full_scale(np.float32) == 1.0
        assert ops.full_scale(np.uint16, max_value=4095) == 4095.0
        assert (ops.DEFAULT_THRESH_FRAC, ops.DEFAULT_TAU) == (jax_ops.DEFAULT_THRESH_FRAC,
                                                              jax_ops.DEFAULT_TAU)
        img = np.zeros((64, 128), np.uint16)
        img[:, ::2] = 4095
        t = torch.from_numpy(img[None])
        for kw in ({}, {"max_value": 4095}):
            got = ops.suspicious_tiles(t, tile=(32, 128), **kw)
            np.testing.assert_array_equal(got, jax_ops.suspicious_tiles(img[None], tile=(32, 128),
                                                                        **kw))
        assert not ops.suspicious_tiles(t).any()
        assert ops.suspicious_tiles(t, max_value=4095).all()

    def test_flags_equal_jax(self, rng):
        imgs = _strokes(rng, (2, 64, 256), np.uint8)
        flags = phi_flags_ref(torch.from_numpy(imgs), 63.75, (32, 128), ops.DEFAULT_TAU).numpy()
        np.testing.assert_array_equal(flags, ops.suspicious_tiles(torch.from_numpy(imgs),
                                                                  thresh=63.75))
        np.testing.assert_array_equal(flags, jax_ops.suspicious_tiles(imgs, thresh=63.75))

    def test_plain_version_runs_on_cpu_without_a_launch(self):
        before = LAUNCHES["phi_detect"]
        ops.edge_density(torch.zeros((1, 32, 128), dtype=torch.uint8))
        assert LAUNCHES["phi_detect"] == before

    @pytest.mark.parametrize("op", [ops.edge_density, ops.suspicious_tiles])
    def test_numpy_input_is_refused(self, op):
        """The tensor's device decides where an op runs: numpy pixels go
        through ``audit_image``/``audit_dataset`` and their ``device``."""
        before = LAUNCHES["phi_detect"]
        with pytest.raises(TypeError, match="torch tensor"):
            op(np.zeros((1, 32, 128), np.uint8))
        assert LAUNCHES["phi_detect"] == before


class TestAudit:
    @pytest.mark.parametrize("bits", [None, 12])
    def test_stored_max_value_and_audit_fail_closed(self, bits):
        img = np.zeros((64, 128), np.uint16)
        img[:, ::2] = 4095  # burned-in text at 12-bit scale
        port, ref = DicomDataset(pixels=img), JaxDataset(pixels=img)
        if bits is not None:
            port["BitsStored"] = ref["BitsStored"] = bits
        assert ops.stored_max_value(port) == jax_ops.stored_max_value(ref) == 4095.0
        assert ops.audit_dataset(port, device="cpu") is True
        assert jax_ops.audit_dataset(ref)

    def test_stored_max_value_narrow_and_float(self):
        for img in (np.full((8, 8), 700, np.uint16), np.zeros((8, 8), np.uint8),
                    np.full((8, 8), 0.5, np.float32)):
            assert ops.stored_max_value(DicomDataset(pixels=img)) == \
                jax_ops.stored_max_value(JaxDataset(pixels=img))

    @pytest.mark.parametrize("modality", ["US", "CT"])
    def test_audit_raw_and_scrubbed_equal_jax(self, gen, modality):
        study = gen.gen_study(f"TPHI-{modality}", modality=modality, n_images=1)
        jds = study.datasets[0]
        ds = study_from_plain(study_to_plain(study)).datasets[0]
        rects = study.phi_rects[jds["SOPInstanceUID"]]
        raw = ops.audit_dataset(ds, device="cpu")
        assert raw is jax_ops.audit_dataset(jds) is True, "synthetic burn-in must be flagged"
        clean = ds.copy()
        clean.pixels = numpy_blank(ds.pixels, rects)
        assert ops.audit_dataset(clean, device="cpu") is False, "scrubbed image must be clean"
        assert ops.audit_image(ds.pixels, device="cpu") == jax_ops.audit_image(jds.pixels)

    def test_flat_image_not_flagged(self):
        img = np.full((256, 256), 100, np.uint8)
        assert not ops.suspicious_tiles(torch.from_numpy(img[None])).any()
        assert ops.audit_image(img, device="cpu") is False

    def test_default_device_is_cuda_or_raises(self):
        img = np.zeros((32, 128), np.uint8)
        if torch.cuda.is_available():
            assert ops.audit_image(img) is False
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                ops.audit_image(img)
