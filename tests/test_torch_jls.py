"""The port's JPEG-Lossless predictor op (``kernels/jls``) and the two
kernel-assisted encodes against the JAX package.

``jls_residuals`` on CPU tensors runs its plain PyTorch version; it is held
against the JAX ``jls_residuals`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it), the JAX ``residuals_ref`` oracle and
both packages' host ``codec.residuals``. ``encode_batch`` and
``fused_encode_batch`` must give the same RJLS bytes as the JAX functions
and as ``codec.encode``. The CUDA kernel itself is held against the plain
version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
Tolerance everywhere is exact: the kernel is integer arithmetic.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.scrub import numpy_blank
from repro.dicom import codec as jax_codec
from repro.kernels.fused.ops import fused_encode_batch as jax_fused_encode_batch
from repro.kernels.jls.ops import encode_batch as jax_encode_batch
from repro.kernels.jls.ops import jls_residuals as jax_jls_residuals
from repro.kernels.jls.ref import residuals_ref as jax_residuals_ref

from repro_torch.dicom import codec
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.fused import cases as fused_cases
from repro_torch.kernels.fused import ref as fused_ref_mod
from repro_torch.kernels.fused.ops import fused_encode_batch
from repro_torch.kernels.jls.ops import encode_batch, jls_residuals
from repro_torch.kernels.jls.ref import residuals_ref


def _full_range(rng, shape, dtype):
    return rng.integers(0, np.iinfo(dtype).max + 1, size=shape).astype(dtype)


def _assert_residual_parity(imgs, sv, bh=64, interpret=True):
    """``interpret=False`` leaves out the JAX kernel in interpret mode (a
    second per shape and sv on the CPU), not its oracle or the codecs."""
    bits = imgs.dtype.itemsize * 8
    before = LAUNCHES["jls"]
    got = jls_residuals(torch.from_numpy(imgs), sv=sv, bh=bh)
    assert got.dtype == torch.int32 and LAUNCHES["jls"] == before  # plain version on a CPU tensor
    got = got.numpy()
    if interpret:
        np.testing.assert_array_equal(got, np.asarray(jax_jls_residuals(imgs, sv=sv, bh=bh)))
    np.testing.assert_array_equal(got, np.asarray(jax_residuals_ref(jnp.asarray(imgs), sv, bits)))
    np.testing.assert_array_equal(got, residuals_ref(torch.from_numpy(imgs), sv, bits).numpy())
    for i in range(imgs.shape[0]):
        np.testing.assert_array_equal(got[i], jax_codec.residuals(imgs[i], sv))
        np.testing.assert_array_equal(got[i], codec.residuals(imgs[i], sv))
    return got


@pytest.mark.parametrize("sv", list(range(1, 8)))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_residuals_equal_jax_every_sv(rng, sv, dtype):
    _assert_residual_parity(_full_range(rng, (2, 70, 90), dtype), sv)


@pytest.mark.parametrize("bh", [8, 32, 64])
@pytest.mark.parametrize("sv", [1, 4])
def test_residuals_130_rows_bh_sweep(rng, bh, sv):
    """The reference's stripe-height sweep: 130 rows leave a partial
    stripe at every bh; the port ignores bh and must agree at each."""
    imgs = (rng.random((1, 130, 64)) * 4095).astype(np.uint16)
    _assert_residual_parity(imgs, sv, bh=bh)


@pytest.mark.parametrize("sv", [4, 5, 6])
def test_residuals_full_range_uint16(rng, sv):
    """Samples >= 32768 widen by value; sv 4-6 leave [0, 2^16) and shift
    negative differences right."""
    imgs = _full_range(rng, (2, 40, 50), np.uint16)
    imgs[0, :, ::2] = 65535
    imgs[1, ::2, :] = 0
    got = _assert_residual_parity(imgs, sv)
    assert got.min() < 0 < got.max()


@pytest.mark.parametrize("shape", [(2, 1, 90), (2, 70, 1), (1, 1, 1), (2, 5, 257)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_residuals_edges(rng, shape, dtype):
    """Every sv against the oracle and both codecs; the JAX kernel at sv 4,
    the predictor that reads all three neighbours."""
    for sv in range(1, 8):
        _assert_residual_parity(_full_range(rng, shape, dtype), sv, interpret=sv == 4)


@pytest.mark.parametrize("sv", fused_cases.SVS)
@pytest.mark.parametrize("offset", fused_cases.OFFSETS)
@pytest.mark.parametrize("shape", fused_cases.SHAPES)
@pytest.mark.parametrize("dtype", fused_cases.DTYPES)
def test_residuals_equal_jax_on_fused_case_table(dtype, shape, offset, sv):
    """The layouts the CUDA kernel's strip walker meets (shared with fused):
    rows that are no 16-byte multiple, a batch cut off a 16-byte boundary,
    H = 1, W = 1, W = 257; the port's plain path against the JAX kernel in
    interpret mode."""
    N = shape[0]
    rng = np.random.default_rng(sum(shape) * 16 + offset * 8 + sv)
    imgs = fused_cases.planes(rng, dtype, shape)[offset:offset + N]
    before = LAUNCHES["jls"]
    got = jls_residuals(torch.from_numpy(imgs), sv=sv)
    assert LAUNCHES["jls"] == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_jls_residuals(imgs, sv=sv)))


@pytest.mark.parametrize("sv", [0, 8])
def test_bad_selection_value_raises(rng, sv):
    with pytest.raises(ValueError, match="selection value"):
        jls_residuals(torch.zeros((1, 4, 4), dtype=torch.uint16), sv=sv)


def test_numpy_input_raises_type_error():
    with pytest.raises(TypeError, match="torch tensor"):
        jls_residuals(np.zeros((1, 4, 4), np.uint16))


def test_residuals_ref_moved_and_still_importable_from_fused():
    assert fused_ref_mod.residuals_ref is residuals_ref


@pytest.mark.parametrize("sv", [1, 5])
@pytest.mark.parametrize("dtype,scale", [(np.uint16, 4095), (np.uint8, 255)])
def test_encode_batch_byte_identical(rng, sv, dtype, scale):
    imgs = (rng.random((3, 48, 64)) * scale).astype(dtype)
    bufs = encode_batch(imgs, sv=sv, device="cpu")
    assert bufs == jax_encode_batch(imgs, sv=sv)
    for i in range(imgs.shape[0]):
        assert bufs[i] == codec.encode(imgs[i], sv) == jax_codec.encode(imgs[i], sv)
        np.testing.assert_array_equal(codec.decode(bufs[i]), imgs[i])


def test_encode_batch_full_range_uint16(rng):
    imgs = _full_range(rng, (2, 33, 47), np.uint16)
    bufs = encode_batch(imgs, device="cpu")
    assert bufs == jax_encode_batch(imgs)
    assert bufs == [codec.encode(p, 1) for p in imgs]


@pytest.mark.parametrize("sv", [1, 6])
def test_fused_encode_batch_byte_identical(rng, sv):
    imgs = (rng.random((3, 48, 64)) * 4095).astype(np.uint16)
    rect_lists = [[(5, 5, 20, 10)], [(0, 0, 64, 4), (40, 30, 100, 100)], []]
    bufs = fused_encode_batch(imgs, rect_lists, sv=sv, device="cpu")
    assert bufs == jax_fused_encode_batch(imgs, rect_lists, sv=sv)
    for i, rl in enumerate(rect_lists):
        blanked = numpy_blank(imgs[i], rl)
        assert bufs[i] == codec.encode(blanked, sv) == jax_codec.encode(blanked, sv)
        np.testing.assert_array_equal(codec.decode(bufs[i]), blanked)


@pytest.mark.parametrize("encode", [
    lambda imgs: encode_batch(imgs),
    lambda imgs: fused_encode_batch(imgs, [[]] * len(imgs)),
], ids=["encode_batch", "fused_encode_batch"])
def test_default_device_is_the_card(rng, encode):
    imgs = (rng.random((1, 8, 8)) * 255).astype(np.uint8)
    if torch.cuda.is_available():
        assert encode(imgs) == [codec.encode(imgs[0], 1)]
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            encode(imgs)
