"""The port's kernel ops (fused scrub+residuals, Rice pre-pass, code lengths
and remainders, scrub) against the JAX package's Pallas kernels (interpret
mode on the CPU), its ``ref.py`` oracles and the host codec.

On CPU tensors each op runs its plain PyTorch version; the CUDA kernels
themselves are held against those plain versions on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``). Tolerance everywhere
is exact: every kernel is integer arithmetic or masking.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.scrub import numpy_blank
from repro.dicom import codec as jax_codec
from repro.kernels.fused.ops import fused_scrub_residuals as jax_fused
from repro.kernels.fused.ref import fused_ref as jax_fused_ref
from repro.kernels.jls import entropy as jax_entropy
from repro.kernels.scrub.ops import pack_rects as jax_pack_rects
from repro.kernels.scrub.ops import scrub_images as jax_scrub
from repro.kernels.scrub.ref import scrub_ref as jax_scrub_ref

from repro_torch.dicom import codec
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.fused import cases as fused_cases
from repro_torch.kernels.fused.ops import fused_scrub_residuals
from repro_torch.kernels.fused.ref import fused_ref
from repro_torch.kernels.jls import entropy
from repro_torch.kernels.scrub import cases as scrub_cases
from repro_torch.kernels.scrub.ops import _empty_at_offset_of, make_blank_fn, pack_rects, scrub_images
from repro_torch.kernels.scrub.ref import scrub_ref


def _full_range(rng, shape, dtype):
    return rng.integers(0, np.iinfo(dtype).max + 1, size=shape).astype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _host_residuals(imgs, rect_lists, sv):
    """The staged host pair: blank, then predictor residuals."""
    return np.stack([jax_codec.residuals(numpy_blank(imgs[i], rect_lists[i]), sv)
                     for i in range(imgs.shape[0])])


def _assert_fused_parity(imgs, rect_lists, sv, bh=64):
    rects = pack_rects(rect_lists)
    np.testing.assert_array_equal(rects, jax_pack_rects(rect_lists))
    got = fused_scrub_residuals(_t(imgs), _t(rects), sv=sv, bh=bh)
    assert got.dtype == torch.int32
    got = got.numpy()
    bits = imgs.dtype.itemsize * 8
    np.testing.assert_array_equal(got, np.asarray(jax_fused(imgs, rects, sv=sv, bh=bh)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_fused_ref(jnp.asarray(imgs), jnp.asarray(rects), sv, bits)))
    np.testing.assert_array_equal(got, fused_ref(_t(imgs), _t(rects), sv, bits).numpy())
    np.testing.assert_array_equal(got, _host_residuals(imgs, rect_lists, sv))
    return got


RECT_CASES = {
    "empty": lambda H, W: [],
    "banner": lambda H, W: [(0, 0, W, max(1, H // 8))],
    "overlapping": lambda H, W: [(2, 2, W // 2, H // 2), (W // 4, H // 4, W // 2, H // 2)],
    "out_of_bounds": lambda H, W: [(W - 5, H - 5, 99, 99), (W + 3, 0, 10, 10)],
    "negative_origin": lambda H, W: [(-7, -3, 15, 12), (-20, 10, 25, 5), (5, -40, 4, 30)],
    "degenerate": lambda H, W: [(5, 5, 0, 10), (5, 5, 10, 0), (0, 0, -4, -4)],
    "full_frame": lambda H, W: [(0, 0, W, H)],
    "stripe_boundary": lambda H, W: [(0, 48, W, 16), (10, 63, 30, 2), (3, 64, 7, 1)],
}


class TestFused:
    @pytest.mark.parametrize("sv", list(range(1, 8)))
    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
    def test_every_sv_and_dtype(self, rng, sv, dtype):
        imgs = _full_range(rng, (2, 70, 90), dtype)
        rl = [[(5, 5, 30, 20), (0, 0, 90, 8)], [(40, 30, 200, 200), (-3, -3, 10, 10)]]
        _assert_fused_parity(imgs, rl, sv)

    @pytest.mark.parametrize("case", sorted(RECT_CASES))
    def test_rect_classes_h_not_multiple_of_64(self, rng, case):
        H, W = 100, 72  # H % 64 != 0: the JAX wrapper pads, the port does not
        imgs = _full_range(rng, (2, H, W), np.uint16)
        _assert_fused_parity(imgs, [RECT_CASES[case](H, W)] * 2, sv=4)

    def test_random_sweep(self, rng):
        for trial in range(3):
            N, H, W = int(rng.integers(1, 3)), int(rng.integers(8, 90)), int(rng.integers(8, 120))
            dtype = (np.uint8, np.uint16)[trial % 2]
            rl = [[(int(rng.integers(-20, W + 20)), int(rng.integers(-20, H + 20)),
                    int(rng.integers(0, W + 40)), int(rng.integers(0, H + 40)))
                   for _ in range(int(rng.integers(0, 5)))] for _ in range(N)]
            _assert_fused_parity(_full_range(rng, (N, H, W), dtype), rl,
                                 int(rng.integers(1, 8)), bh=16)

    @pytest.mark.parametrize("dtype", fused_cases.DTYPES)
    @pytest.mark.parametrize("shape", fused_cases.SHAPES)
    @pytest.mark.parametrize("offset", fused_cases.OFFSETS)
    def test_chunk_layouts_equal_pallas(self, rng, dtype, shape, offset):
        """The layouts the CUDA kernel's strips of 16-byte chunks meet
        (``kernels/fused/cases.py``), on the plain version: a view off a
        16-byte boundary, rows that are no 16-byte multiple, H = 1, W = 1,
        W = 257, rect x-edges at chunk boundaries and ends that wrap int32,
        every sv. Exact against the Pallas kernel (interpret mode) and the
        staged host pair."""
        N, H, W = shape
        base = fused_cases.planes(rng, dtype, shape)
        imgs = base[offset:offset + N]
        rl = fused_cases.rect_lists(N, H, W)
        rects = pack_rects(rl)
        for sv in fused_cases.SVS:
            got = fused_scrub_residuals(torch.from_numpy(base)[offset:offset + N], _t(rects), sv=sv)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fused(imgs, rects, sv=sv)))
            np.testing.assert_array_equal(got.numpy(), _host_residuals(imgs, rl, sv))

    def test_full_range_uint16_never_sign_extends(self):
        img = np.full((1, 4, 6), 40000, np.uint16)
        img[0, 2, 3] = 65535
        res = _assert_fused_parity(img, [[]], sv=1)
        # (0,0): 40000 - 2^15 stays positive; a sign-extended read would not
        assert res[0, 0, 0] == 40000 - 32768
        assert res[0, 2, 3] == 65535 - 40000
        assert res[0, 2, 4] == 40000 - 65535

    def test_blanked_neighbors_feed_prediction(self):
        img = np.full((1, 32, 64), 100, np.uint16)
        res = _assert_fused_parity(img, [[(8, 8, 16, 16)]], sv=1)[0]
        assert (res[8:24, 24] == 100).all()  # left neighbour blanked -> 100 - 0
        assert (res[8:24, 25] == 0).all()

    def test_roundtrip_through_codec(self, rng):
        imgs = _full_range(rng, (1, 40, 56), np.uint8)
        rl = [[(4, 4, 20, 10)]]
        res = fused_scrub_residuals(_t(imgs), _t(pack_rects(rl)), sv=1).numpy()[0]
        np.testing.assert_array_equal(codec.reconstruct(res, sv=1, bits=8),
                                      numpy_blank(imgs[0], rl[0]))

    def test_cpu_tensor_runs_plain_version_without_launch(self, rng):
        before = dict(LAUNCHES)
        imgs = _full_range(rng, (1, 16, 16), np.uint8)
        fused_scrub_residuals(_t(imgs), _t(pack_rects([[]])))
        assert LAUNCHES == before

    def test_rejects_bad_selection_value(self, rng):
        imgs = _t(_full_range(rng, (1, 8, 8), np.uint8))
        with pytest.raises(ValueError):
            fused_scrub_residuals(imgs, _t(pack_rects([[]])), sv=8)


class TestScrub:
    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
    @pytest.mark.parametrize("case", ["overlapping", "out_of_bounds", "negative_origin",
                                      "degenerate", "stripe_boundary"])
    def test_matches_pallas_ref_and_numpy_blank(self, rng, dtype, case):
        H, W = 70, 50
        if dtype == np.float32:
            imgs = (rng.random((2, H, W)) * 1000).astype(dtype)
        else:
            imgs = _full_range(rng, (2, H, W), dtype)
        rl = [RECT_CASES[case](H, W), RECT_CASES["banner"](H, W)]
        rects = pack_rects(rl)
        got = scrub_images(_t(imgs), _t(rects))
        assert got.dtype == _t(imgs).dtype
        got = got.numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_scrub(imgs, rects)))
        np.testing.assert_array_equal(
            got, np.asarray(jax_scrub_ref(jnp.asarray(imgs), jnp.asarray(rects))))
        np.testing.assert_array_equal(got, scrub_ref(_t(imgs), _t(rects)).numpy())
        for i in range(2):
            np.testing.assert_array_equal(got[i], numpy_blank(imgs[i], rl[i]))

    # the JAX package without x64 has no 8-byte pixel type
    @pytest.mark.parametrize("dtype", [d for d in scrub_cases.DTYPES if np.dtype(d).itemsize < 8])
    @pytest.mark.parametrize("shape", scrub_cases.SHAPES)
    @pytest.mark.parametrize("offset", scrub_cases.OFFSETS)
    def test_misaligned_view_and_odd_rows_match_pallas(self, rng, dtype, shape, offset):
        """The layouts the CUDA kernel's 16-byte chunks meet
        (``kernels/scrub/cases.py``), on the plain version: a view starting
        off a 16-byte boundary, rows that are no 16-byte multiple, a plane
        smaller than a chunk; image i takes the i-th rect set in turn (rect
        x-edges at vector offsets, negative and wrapping rects, a padding
        rect, the full frame). Exact against the Pallas kernel, its oracle
        and numpy_blank."""
        N, H, W = shape
        base = scrub_cases.planes(rng, dtype, shape)
        imgs = base[offset:offset + N]
        sets = list(scrub_cases.RECT_SETS.values())
        rl = [sets[i % len(sets)](H, W) for i in range(N)]
        rects = pack_rects(rl)
        got = scrub_images(torch.from_numpy(base)[offset:offset + N], _t(rects)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_scrub(imgs, rects)))
        np.testing.assert_array_equal(
            got, np.asarray(jax_scrub_ref(jnp.asarray(imgs), jnp.asarray(rects))))
        for i in range(N):
            np.testing.assert_array_equal(got[i], numpy_blank(imgs[i], rl[i]))

    @pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32, torch.int64])
    def test_output_starts_at_the_inputs_offset_from_16_bytes(self, dtype):
        """The CUDA kernel moves 16-byte chunks of input and output alike:
        the wrapper's output starts at the input's offset from a 16-byte
        boundary, for a view that starts anywhere."""
        base = torch.zeros((5, 3, 7), dtype=dtype)
        for view in (base, base[1:], base[2:], base[3:4]):
            out = _empty_at_offset_of(view)
            assert out.data_ptr() % 16 == view.data_ptr() % 16
            assert out.shape == view.shape and out.dtype == dtype and out.is_contiguous()

    def test_full_range_uint16_kept(self):
        img = np.full((1, 8, 8), 65535, np.uint16)
        img[0, 0, 0] = 32768
        got = scrub_images(_t(img), _t(pack_rects([[(4, 4, 2, 2)]]))).numpy()
        assert got[0, 0, 0] == 32768 and got[0, 0, 1] == 65535 and got[0, 4, 4] == 0

    def test_pack_rects_refuses_to_truncate(self):
        with pytest.raises(ValueError, match="refusing to truncate"):
            pack_rects([[(0, 0, 1, 1)] * 3], R=2)
        packed = pack_rects([[(0, 0, 1, 1)] * 2, []], R=4)
        assert packed.shape == (2, 4, 4) and packed.dtype == np.int32
        np.testing.assert_array_equal(packed, jax_pack_rects([[(0, 0, 1, 1)] * 2, []], R=4))
        assert pack_rects([]).shape == (0, 1, 4)

    def test_blank_fn_adapter_on_cpu(self, rng):
        fn = make_blank_fn(device="cpu")
        assert fn.rect_blank_semantics is True
        img = _full_range(rng, (20, 30), np.uint16)
        np.testing.assert_array_equal(fn(img, [(2, 2, 5, 5)]), numpy_blank(img, [(2, 2, 5, 5)]))


def _plan_batch(res, prepass, len_rem, bh):
    N, H, W = res.shape
    u, rs = prepass(res, bh)
    rs = np.asarray(rs)
    ks = np.array([codec._rice_k_from_sum(int(rs[j].sum(dtype=np.int64)), H * W)
                   for j in range(N)], np.int32)
    lens, rem = len_rem(u, ks, bh)
    return np.asarray(u), rs, ks, np.asarray(lens), np.asarray(rem)


def _port(res):
    return _plan_batch(
        torch.from_numpy(res.astype(np.int32)),
        lambda r, bh: tuple(t for t in entropy.rice_prepass(r, bh=bh)),
        lambda u, ks, bh: entropy.rice_len_rem(u, ks, bh=bh), 16)


def _jax(res):
    return _plan_batch(
        res.astype(np.int32),
        lambda r, bh: jax_entropy.rice_prepass(r, bh=bh),
        lambda u, ks, bh: jax_entropy.rice_len_rem(u, ks, bh=bh), 16)


class TestEntropy:
    def test_qmax_comes_from_the_codec(self):
        assert entropy._QMAX is codec._QMAX
        assert entropy._QMAX == jax_codec._QMAX == jax_entropy._QMAX
        assert entropy._ESC_LEN == jax_entropy._ESC_LEN == 89

    @pytest.mark.parametrize("shape,sv", [((3, 48, 40), 1), ((2, 20, 24), 3), ((2, 70, 33), 7)])
    def test_plan_matches_pallas_and_host(self, rng, shape, sv):
        imgs = _full_range(rng, shape, np.uint16)
        res = codec.residuals_batch(imgs, sv)
        port, ref = _port(res), _jax(res)
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a.numpy() if hasattr(a, "numpy") else a, b)
        u, _, ks, lens, rem = port
        N = shape[0]
        for j in range(N):
            plan = codec.rice_plan_from_prepass(u[j].reshape(-1), int(ks[j]), lens[j], rem[j])
            host = jax_codec.rice_plan(res[j])
            assert plan.k == host.k
            np.testing.assert_array_equal(plan.lens, host.lens)
            assert codec.rice_pack(plan) == jax_codec.rice_pack(host)

    def test_escapes_and_k_zero(self):
        res = np.zeros((3, 32, 32), np.int64)
        res[1, 3, 5] = 2**16
        res[2, 10, 2] = -(2**15)
        u, _, ks, lens, rem = _port(res)
        assert ks[0] == 0 and (rem[0] == 0).all() and (lens[0] == 1).all()
        for j in (1, 2):
            assert (lens[j] == entropy._ESC_LEN).sum() >= 1
        for a, b in zip((u, ks, lens, rem), (lambda t: (t[0], t[2], t[3], t[4]))(_jax(res))):
            np.testing.assert_array_equal(a, b)
        for j in range(3):
            plan = codec.rice_plan_from_prepass(u[j].reshape(-1), int(ks[j]), lens[j], rem[j])
            assert codec.rice_pack(plan) == jax_codec.rice_pack(jax_codec.rice_plan(res[j]))

    def test_logical_shift_and_row_sum_wrap_match_pallas(self):
        # int32 patterns no codec produces: negative u (logical >> by k) and
        # row sums past 2^31 (int32 wrap), still bit-equal to the Pallas ops
        res = np.full((1, 4, 16), 2**29, np.int32)
        res[0, 1] = -(2**30)
        u_t, rs_t = entropy.rice_prepass(torch.from_numpy(res))
        u_j, rs_j = jax_entropy.rice_prepass(res, bh=16)
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
        np.testing.assert_array_equal(rs_t.numpy(), np.asarray(rs_j))
        for k in (0, 5, 30):
            ks = np.array([k], np.int32)
            lens_t, rem_t = entropy.rice_len_rem(u_t, ks)
            lens_j, rem_j = jax_entropy.rice_len_rem(u_j, ks, bh=16)
            np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
            np.testing.assert_array_equal(rem_t.numpy(), np.asarray(rem_j))

    def test_rice_parameter_range_checked(self):
        u = torch.zeros((2, 4, 4), dtype=torch.int32)
        with pytest.raises(ValueError):
            entropy.rice_len_rem(u, np.array([0, 31], np.int32))
        with pytest.raises(ValueError):
            entropy.rice_len_rem(u, np.array([1], np.int32))
