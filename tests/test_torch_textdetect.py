"""The port's text-band detector (``repro_torch.kernels.textdetect``,
``repro_torch.detect.regions``) against the JAX package's, exactly.

On the CPU the port's ops run the kernel's plain PyTorch version; the JAX
ops run the Pallas kernel in interpret mode. Every profile must be equal
(``np.array_equal`` on int32), including the float32 threshold straddle
(2457.0001 rounds to 2457.0f) and zero padding that binarizes at
``thresh <= 0``. ``tests/test_torch_gpu.py`` holds the CUDA kernel against
the plain version on the card.
"""
import numpy as np
import pytest
import torch

from repro.detect import regions as jax_regions
from repro.kernels.textdetect import ops as jax_ops
from repro.kernels.textdetect import ref as jax_ref

from repro_torch.carry import study_from_plain, study_to_plain
from repro_torch.core.scrub import numpy_blank
from repro_torch.detect.regions import (
    bands_from_hits,
    detect_bands_np,
    merge_rects,
    rects_from_bands,
)
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.textdetect import cases as text_cases
from repro_torch.kernels.textdetect import ops, ref

SHAPES = [(1, 32, 128), (2, 96, 256), (1, 97, 300), (3, 64, 513)]
TILES = [(32, 128), (16, 64)]
TILE = (32, 128)


def _images(rng, shape, dtype):
    """Low anatomy plus 1-px bright strokes every 3 px over a row band; the
    integer types span their full range."""
    if dtype == np.float32:
        imgs = (rng.random(shape) * 0.5).astype(np.float32)
        imgs[:, 5:20, ::3] = 1.0
        return imgs
    top = np.iinfo(dtype).max
    imgs = rng.integers(0, top // 2, size=shape, dtype=np.int64).astype(dtype)
    imgs[:, 5:20, ::3] = top
    # a bright block in the upper half of the range (>= 32768 for uint16)
    imgs[:, 40:44, 7:90] = rng.integers(top // 2, top + 1, size=imgs[:, 40:44, 7:90].shape)
    return imgs


def _thresh(dtype):
    return 0.6 if dtype == np.float32 else np.iinfo(dtype).max * 0.6


def _assert_profiles_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class TestKernelParity:
    @pytest.mark.parametrize("tile", TILES)
    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_profiles_equal_jax_kernel_and_oracle(self, rng, shape, dtype, tile):
        imgs = _images(rng, shape, dtype)
        thresh = _thresh(dtype)
        got = ops.tile_profiles(torch.from_numpy(imgs), thresh=thresh, tile=tile)
        assert got[0].shape == (shape[0], -(-shape[1] // tile[0]), -(-shape[2] // tile[1]), tile[0])
        _assert_profiles_equal(got, ref.tile_profiles_ref(ref.pad_to_tiles_np(imgs, tile),
                                                          thresh, tile))
        _assert_profiles_equal(got, jax_ops.tile_profiles(imgs, thresh=thresh, tile=tile,
                                                          interpret=True))

    @pytest.mark.parametrize("dtype", text_cases.DTYPES)
    @pytest.mark.parametrize("shape", text_cases.SHAPES)
    @pytest.mark.parametrize("offset", text_cases.OFFSETS)
    def test_chunk_layouts_equal_jax_kernel(self, rng, dtype, shape, offset):
        """The layouts the CUDA kernel's 16-byte chunks, 32-pixel words and
        row joins meet (``kernels/textdetect/cases.py``), on the plain
        version: a view off a 16-byte boundary, rows that are no 16-byte
        multiple, H = 1, W = 1, W = 257, tiles (24, 100), (32, 128),
        (32, 2048) and (1, 1), a tile row of hits and runs across chunks,
        lanes and groups, every pixel type, the float32 straddle and thresh
        <= 0 on a ragged frame. Exact against the Pallas kernel (interpret
        mode)."""
        N = shape[0]
        base = text_cases.planes(rng, dtype, shape)
        imgs = base[offset:offset + N]
        for tile in text_cases.TILES:
            for thresh in text_cases.threshes(dtype, shape):
                got = ops.tile_profiles(torch.from_numpy(base)[offset:offset + N], thresh=thresh,
                                        tile=tile)
                _assert_profiles_equal(got, jax_ops.tile_profiles(imgs, thresh=thresh, tile=tile,
                                                                  interpret=True))

    @pytest.mark.parametrize("thresh", [2457.0, 2457.0001, 0.0, -3.5])
    def test_thresholds_straddle_and_padding(self, rng, thresh):
        """2457.0001 is 2457.0f in float32, so pixel 2457 is a hit (a double
        compare would miss it); at thresh <= 0 every zero of the padding past
        the ragged edge is a hit, as in the padded reference."""
        imgs = rng.integers(2450, 2465, size=(2, 50, 200)).astype(np.uint16)
        imgs[0, :, 3] = 2457
        got = ops.tile_profiles(torch.from_numpy(imgs), thresh=thresh, tile=TILE)
        _assert_profiles_equal(got, jax_ops.tile_profiles(imgs, thresh=thresh, tile=TILE,
                                                          interpret=True))
        rows, cols, runs = (t.numpy() for t in got)
        if thresh == 2457.0001:
            assert (imgs[0, :, 3] >= np.float32(thresh)).all()
            assert cols[0, 0, 0, 3] == 32
        if thresh <= 0:
            assert (rows == 128).all() and (runs == 128).all()  # padding counts
        np.testing.assert_array_equal(
            ops.row_hit_profile(torch.from_numpy(imgs), thresh=thresh, tile=TILE),
            jax_ops.row_hit_profile(imgs, thresh=thresh, tile=TILE, interpret=True))

    def test_row_hits_equal_oracle_and_jax(self, rng):
        imgs = (rng.random((2, 70, 200)) * 2000).astype(np.uint16)
        imgs[:, 5:20, ::3] = 4095
        hits = ops.row_hit_profile(torch.from_numpy(imgs), thresh=2457.0, tile=TILE)
        assert hits.dtype == np.int32 and hits.shape == (2, 70)
        np.testing.assert_array_equal(hits, ref.row_hits_np(imgs, 2457.0, TILE))
        np.testing.assert_array_equal(hits, jax_ref.row_hits_np(imgs, 2457.0, TILE))
        np.testing.assert_array_equal(
            hits, jax_ops.row_hit_profile(imgs, thresh=2457.0, tile=TILE, interpret=True))

    def test_saturated_tile_and_strokes(self):
        """A saturated tile is one tile-wide run; 1-px strokes are runs of 1
        — and the run never crosses a tile edge."""
        text = np.zeros((1, 32, 256), np.uint16)
        text[0, :, ::3] = 4095
        sat = np.full((1, 32, 256), 4095, np.uint16)
        for imgs, run in ((text, 1), (sat, 128)):
            _, _, runs = ops.tile_profiles(torch.from_numpy(imgs), thresh=2457.0, tile=TILE)
            assert runs.tolist() == [[[run, run]]]
            np.testing.assert_array_equal(runs.numpy().max(axis=(1, 2)),
                                          jax_ref.max_run_np(imgs, 2457.0, TILE))

    def test_plain_version_runs_on_cpu_without_a_launch(self, rng):
        before = LAUNCHES["textdetect"]
        ops.tile_profiles(torch.zeros((1, 32, 128), dtype=torch.uint8))
        assert LAUNCHES["textdetect"] == before

    @pytest.mark.parametrize("op", [ops.tile_profiles, ops.row_hits, ops.row_hit_profile])
    def test_numpy_input_is_refused(self, op):
        """The tensor's device decides where an op runs: a numpy array would
        run the plain version on the host unnoticed, so it raises."""
        before = LAUNCHES["textdetect"]
        with pytest.raises(TypeError, match="torch tensor"):
            op(np.zeros((1, 32, 128), np.uint16), thresh=1.0)
        assert LAUNCHES["textdetect"] == before

    def test_dtype_aware_threshold(self):
        for dtype, mv in ((np.uint8, None), (np.uint16, None), (np.uint16, 4095), (np.float32, None)):
            assert ops.binarize_thresh(dtype, mv) == jax_ops.binarize_thresh(dtype, mv)
        assert ops.binarize_thresh(np.uint16, max_value=4095) == 4095 * 0.6

    def test_default_threshold_follows_dtype(self, rng):
        imgs = _images(rng, (1, 64, 256), np.uint16)
        _assert_profiles_equal(ops.tile_profiles(torch.from_numpy(imgs), max_value=4095),
                               jax_ops.tile_profiles(imgs, max_value=4095, interpret=True))


class TestBands:
    @pytest.mark.parametrize("case", [
        ("hot rows group, pad and merge", 100, dict(min_rows=2, pad_rows=2), [(8, 32)]),
        ("width-relative, narrow", 100, {}, None),
        ("width-relative, wide", 1000, {}, []),
        ("clipped at the frame", 100, dict(min_rows=2, pad_rows=3), [(0, 7), (34, 40)]),
        ("empty profile", 128, {}, []),
    ], ids=lambda c: c[0])
    def test_bands_equal_jax(self, case):
        name, width, kw, want = case
        if name.startswith("hot"):
            hits = np.zeros(100, np.int32)
            hits[10:20] = 50
            hits[23:30] = 50   # padding fuses it with the first band
            hits[80:81] = 50   # a single row: below min_rows
        elif name.startswith("width"):
            hits = np.full(10, 5, np.int32)
            want = [(0, 10)] if width == 100 else []
        elif name.startswith("clipped"):
            hits = np.zeros(40, np.int32)
            hits[0:4] = 9
            hits[37:40] = 9
        else:
            hits = np.zeros(64, np.int32)
        got = bands_from_hits(hits, width, row_frac=0.04, **kw)
        assert got == want == jax_regions.bands_from_hits(hits, width, row_frac=0.04, **kw)

    def test_rects_are_full_width(self):
        bands = [(4, 10), (20, 25)]
        assert rects_from_bands(bands, 640) == [(0, 4, 640, 6), (0, 20, 640, 5)]
        assert rects_from_bands(bands, 640) == jax_regions.rects_from_bands(bands, 640)


class TestMergeRects:
    @pytest.mark.parametrize("rects,want", [
        ([(0, 0, 10, 5), (0, 0, 10, 5), (3, 3, 0, 9), (1, 1, 4, 0)], [(0, 0, 10, 5)]),
        ([(0, 0, 100, 50), (10, 10, 20, 20)], [(0, 0, 100, 50)]),
        ([(10, 10, 20, 20), (0, 0, 100, 50)], [(0, 0, 100, 50)]),
        ([(0, 0, 640, 20), (0, 15, 640, 30)], [(0, 0, 640, 45)]),
        ([(0, 0, 640, 20), (0, 20, 640, 10)], [(0, 0, 640, 30)]),
        ([(0, 5, 30, 10), (30, 5, 20, 10)], [(0, 5, 50, 10)]),
        ([(0, 0, 100, 20), (50, 10, 100, 20)], [(0, 0, 100, 20), (50, 10, 100, 20)]),
        ([(0, 0, 64, 8), (0, 8, 64, 8), (0, 16, 64, 8)], [(0, 0, 64, 24)]),
    ], ids=["dedupe", "contained", "contained-rev", "stacked", "touching", "side-by-side",
            "misaligned", "chain"])
    def test_merge_equals_jax(self, rects, want):
        assert merge_rects(rects) == want == jax_regions.merge_rects(rects)

    def test_blanked_set_invariant(self, rng):
        for _ in range(20):
            rects = [(int(rng.integers(0, 50)), int(rng.integers(0, 50)),
                      int(rng.integers(-2, 30)), int(rng.integers(-2, 30))) for _ in range(6)]
            before = np.zeros((70, 70), bool)
            after = np.zeros((70, 70), bool)
            for x, y, w, h in rects:
                if w > 0 and h > 0:
                    before[y : y + h, x : x + w] = True
            merged = merge_rects(rects)
            assert merged == jax_regions.merge_rects(rects)
            for x, y, w, h in merged:
                after[y : y + h, x : x + w] = True
            np.testing.assert_array_equal(before, after)


class TestDetectBands:
    def test_generator_text_is_found_and_blanking_clears_it(self, gen):
        study = study_from_plain(study_to_plain(gen.gen_study("TTD-US", modality="US", n_images=1)))
        ds = study.datasets[0]
        H, _ = ds.pixels.shape
        bands, rects = detect_bands_np(ds.pixels, thresh=255 * 0.6, row_frac=0.04)
        assert (bands, rects) == jax_regions.detect_bands_np(ds.pixels, thresh=255 * 0.6,
                                                             row_frac=0.04)
        covered = np.zeros(H, bool)
        for y0, y1 in bands:
            covered[y0:y1] = True
        for x, y, w, h in study.phi_rects[ds["SOPInstanceUID"]]:
            assert covered[max(0, y) : min(H, y + h)].all()
        assert detect_bands_np(numpy_blank(ds.pixels, rects), thresh=255 * 0.6,
                               row_frac=0.04)[0] == []

    def test_clean_anatomy_is_quiet(self, gen):
        study = gen.gen_study("TTD-CT", modality="CT", n_images=3)
        ds = study.datasets[1]  # only every 17th CT slice carries the banner
        assert ds["SOPInstanceUID"] not in study.phi_rects
        assert detect_bands_np(ds.pixels, thresh=4095 * 0.6, row_frac=0.04)[0] == []

    def test_precomputed_row_hits_short_circuit(self, rng):
        img = (rng.random((64, 128)) * 1000).astype(np.uint16)
        img[10:20, ::3] = 4095
        thresh = 4095 * 0.6
        hits = ops.row_hit_profile(torch.from_numpy(img[None]), thresh=thresh, tile=TILE)[0]
        direct = detect_bands_np(img, thresh=thresh, row_frac=0.04)
        via_hits = detect_bands_np(img, thresh=thresh, row_frac=0.04, row_hits=hits)
        assert direct == via_hits == jax_regions.detect_bands_np(img, thresh=thresh, row_frac=0.04)
        assert direct[0]
