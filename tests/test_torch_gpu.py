"""The port's CUDA kernels and its kernel path on the card, held against the
plain PyTorch versions and the host path (exact).

Every test here is marked ``gpu`` and skips where no card is present. The
file imports nothing of JAX or of the JAX package, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from repro_torch.catalog import And, Contains, In, Not, Or, Range, StudyCatalog
from repro_torch.core import DeidPipeline, PseudonymService, TrustMode, build_request
from repro_torch.core.batch import BatchedDeidExecutor
from repro_torch.detect import DetectorPolicy
from repro_torch.dicom.generator import StudyGenerator
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.bitmap import cases as bitmap_cases
from repro_torch.kernels.bitmap.ops import (
    OPCODES,
    combine_bitmaps,
    combine_bitmaps_torch,
    pack_mask,
    program_limits,
    schedule_program,
)
from repro_torch.kernels.build import bind
from repro_torch.kernels.bitmap.ref import combine_bitmaps_ref
from repro_torch.dicom import codec
from repro_torch.kernels.fused import cases as fused_cases
from repro_torch.kernels.fused.ops import fused_encode_batch, fused_scrub_residuals
from repro_torch.kernels.fused.ref import fused_ref
from repro_torch.kernels.jls import entropy
from repro_torch.kernels.jls.ops import encode_batch, jls_residuals
from repro_torch.kernels.jls.ref import residuals_ref
from repro_torch.kernels.phi_detect import cases as phi_cases
from repro_torch.kernels.phi_detect import ops as phi_ops
from repro_torch.kernels.phi_detect.ref import edge_density_ref
from repro_torch.kernels.scrub import cases as scrub_cases
from repro_torch.kernels.scrub.ops import pack_rects, scrub_images
from repro_torch.kernels.scrub.ref import scrub_ref
from repro_torch.kernels.textdetect import cases as text_cases
from repro_torch.kernels.textdetect.ops import tile_profiles
from repro_torch.kernels.textdetect.ref import tile_profiles_torch
from test_torch_decode_attn import CASES as DECODE_ATTN_CASES
from test_torch_decode_attn import FAULT_MARGIN as DECODE_ATTN_FAULT_MARGIN
from test_torch_decode_attn import assert_within_limit as decode_attn_within_limit
from test_torch_decode_attn import draw as decode_attn_draw
from test_torch_decode_attn import oracle as decode_attn_oracle
from test_torch_decode_attn import planted_faults as decode_attn_faults

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _full_range(rng, shape, dtype):
    return rng.integers(0, np.iinfo(dtype).max + 1, size=shape).astype(dtype)


def _mk_items(rng, n):
    items = []
    for i in range(n):
        shape = (60, 80) if i % 3 else (48, 48)
        dtype = np.uint16 if i % 2 else np.uint8
        items.append((_full_range(rng, shape, dtype), [(4, 4, 24, 8)] if i % 4 else []))
    return items


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_kernels_equal_plain_versions(rng, cuda, dtype):
    imgs = _full_range(rng, (3, 70, 300), dtype)
    rl = [[(5, 5, 30, 20), (-3, -3, 10, 10)], [(40, 30, 500, 200)], []]
    images = torch.from_numpy(imgs).to(cuda)
    rects = torch.from_numpy(pack_rects(rl)).to(cuda)
    bits = imgs.dtype.itemsize * 8
    before = dict(LAUNCHES)
    for sv in range(1, 8):
        res = fused_scrub_residuals(images, rects, sv=sv)
        assert torch.equal(res, fused_ref(images, rects, sv, bits))
    u, rs = entropy.rice_prepass(res)
    u_p, rs_p = entropy.rice_prepass_plain(res)
    assert torch.equal(u, u_p) and torch.equal(rs, rs_p)
    ks = torch.tensor([0, 4, 30], dtype=torch.int32, device=cuda)
    for a, b in zip(entropy.rice_len_rem(u, ks), entropy.rice_len_rem_plain(u, ks)):
        assert torch.equal(a, b)
    assert torch.equal(scrub_images(images, rects), scrub_ref(images, rects))
    torch.cuda.synchronize()
    assert LAUNCHES["fused"] - before["fused"] == 7
    assert all(LAUNCHES[k] - before[k] == 1 for k in ("rice_prepass", "rice_len_rem", "scrub"))


@pytest.mark.parametrize("dtype", scrub_cases.DTYPES)
@pytest.mark.parametrize("shape", scrub_cases.SHAPES)
@pytest.mark.parametrize("offset", scrub_cases.OFFSETS)
def test_scrub_kernel_equals_plain_version_at_chunk_edges(rng, cuda, dtype, shape, offset):
    """The kernel's 16-byte chunks against every layout they meet
    (``kernels/scrub/cases.py``): a base off a 16-byte boundary (the scalar
    head), rows that are no 16-byte multiple (chunks across a row end),
    planes that are no chunk multiple (the scalar tail) or smaller than one
    chunk, rect edges at vector offsets; all four item sizes; exact."""
    N, H, W = shape
    images = torch.from_numpy(scrub_cases.planes(rng, dtype, shape)).to(cuda)[offset:offset + N]
    view = scrub_cases.SAME_WIDTH_INT[images.element_size()]
    before = LAUNCHES["scrub"]
    for make in scrub_cases.RECT_SETS.values():
        rects = torch.from_numpy(pack_rects([make(H, W)] * N)).to(cuda)
        got = scrub_images(images, rects)
        assert got.shape == images.shape and got.dtype == images.dtype
        assert torch.equal(got.view(view), scrub_ref(images, rects).view(view))
    torch.cuda.synchronize()
    assert LAUNCHES["scrub"] - before == len(scrub_cases.RECT_SETS)


def test_scrub_kernel_refuses_grid_past_limit(cuda):
    """Images went to grid z, whose limit is 65535: the kernel now launches
    them in slabs, so 65536 images are scrubbed like any batch."""
    images = torch.randint(1, 256, (65536, 1, 3), dtype=torch.uint8, device=cuda)
    rects = torch.zeros((65536, 1, 4), dtype=torch.int32, device=cuda)
    rects[1::2, 0] = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=cuda)
    got = scrub_images(images, rects)
    assert torch.equal(got, scrub_ref(images, rects))
    assert (got[-1, 0, 1] == 0).item() and (got[-2, 0, 1] != 0).item()


def test_scrub_kernel_takes_any_rect_count_and_plane_size(rng, cuda):
    """More rects than a block's shared memory holds at once (3072), and a
    plane of 2^31 pixels or more (row segments under 2^31 pixels)."""
    images = torch.from_numpy(_full_range(rng, (2, 70, 301), np.uint16)).to(cuda)
    rl = [[(int(x), int(y), int(w), int(h)) for x, y, w, h in zip(
        rng.integers(-5, 301, 5000), rng.integers(-5, 70, 5000), rng.integers(1, 9, 5000),
        rng.integers(1, 3, 5000))]] * 2
    rects = torch.from_numpy(pack_rects(rl)).to(cuda)
    assert torch.equal(scrub_images(images, rects), scrub_ref(images, rects))
    H, W = 32768, 65537  # 2^31 + 32768 pixels
    plane = torch.randint(1, 256, (1, H, W), dtype=torch.uint8, device=cuda)
    rects = torch.tensor([[[5, 0, 3, H], [0, H - 2, W, 2], [W - 1, 30000, 1, 10]]],
                         dtype=torch.int32, device=cuda)
    got = scrub_images(plane, rects)
    assert torch.equal(got, scrub_ref(plane, rects))
    assert got[0, H - 1].sum().item() == 0 and got[0, 0, 4].item() == plane[0, 0, 4].item()


@pytest.mark.parametrize("dtype", fused_cases.DTYPES)
@pytest.mark.parametrize("shape", fused_cases.SHAPES)
@pytest.mark.parametrize("offset", fused_cases.OFFSETS)
def test_fused_kernel_equals_plain_version_at_chunk_edges(rng, cuda, dtype, shape, offset):
    """The fused kernel's strips of 16-byte chunks against the layouts of
    ``kernels/fused/cases.py``: rows that are no 16-byte multiple and a base
    off a 16-byte boundary (the pixel-load path), H = 1, W = 1, W = 257,
    rect x-edges at chunk boundaries and ends that wrap int32, every sv;
    exact."""
    N, H, W = shape
    images = torch.from_numpy(fused_cases.planes(rng, dtype, shape)).to(cuda)[offset:offset + N]
    rects = torch.from_numpy(pack_rects(fused_cases.rect_lists(N, H, W))).to(cuda)
    bits = images.element_size() * 8
    before = LAUNCHES["fused"]
    for sv in fused_cases.SVS:
        got = fused_scrub_residuals(images, rects, sv=sv)
        assert torch.equal(got, fused_ref(images, rects, sv, bits)), sv
    torch.cuda.synchronize()
    assert LAUNCHES["fused"] - before == len(fused_cases.SVS)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("W", [304, 301])
def test_fused_kernel_takes_any_rect_count(rng, cuda, dtype, W):
    """More rects than a block's shared memory holds at once (2048 beside
    the staged rows), on the 16-byte path (W = 304) and the pixel path
    (W = 301); exact."""
    images = torch.from_numpy(_full_range(rng, (2, 70, W), dtype)).to(cuda)
    rl = [[(int(x), int(y), int(w), int(h)) for x, y, w, h in zip(
        rng.integers(-5, W, 5000), rng.integers(-5, 70, 5000), rng.integers(1, 9, 5000),
        rng.integers(1, 3, 5000))]] * 2
    rects = torch.from_numpy(pack_rects(rl)).to(cuda)
    bits = images.element_size() * 8
    for sv in (1, 7):
        assert torch.equal(fused_scrub_residuals(images, rects, sv=sv),
                           fused_ref(images, rects, sv, bits)), sv


@pytest.mark.parametrize("dtype", text_cases.DTYPES)
@pytest.mark.parametrize("shape", text_cases.SHAPES)
@pytest.mark.parametrize("offset", text_cases.OFFSETS)
def test_textdetect_kernel_equals_plain_version_at_chunk_edges(rng, cuda, dtype, shape, offset):
    """The textdetect kernel's chunk words and row folds against the layouts
    of ``kernels/textdetect/cases.py``: tiles (24, 100), (32, 128),
    (32, 2048) and (1, 1), ragged rows and a base off a 16-byte boundary,
    H = 1, W = 1, W = 257, a tile row of hits and a run across lanes, every
    pixel type, the float32 straddle and thresh <= 0 on a ragged frame;
    exact."""
    N = shape[0]
    images = torch.from_numpy(text_cases.planes(rng, dtype, shape)).to(cuda)[offset:offset + N]
    before = LAUNCHES["textdetect"]
    calls = 0
    for tile in text_cases.TILES:
        for thresh in text_cases.threshes(dtype, shape):
            for got, want in zip(tile_profiles(images, thresh=thresh, tile=tile),
                                 tile_profiles_torch(images, thresh, tile)):
                assert torch.equal(got, want), (tile, thresh)
            calls += 1
    torch.cuda.synchronize()
    assert LAUNCHES["textdetect"] - before == calls


def test_kernels_take_65536_images_and_rows(rng, cuda):
    """Images and rows past the 65535 of a grid's y and z: fused, jls and
    both Rice passes at N = 65536, fused and jls at H = 65536, textdetect
    and phi_detect at 65536 images and 65537 tile rows; each equal to its
    plain version."""
    for shape in ((65536, 2, 9), (2, 65536, 9)):
        for dtype in (np.uint8, np.uint16):
            images = torch.from_numpy(_full_range(rng, shape, dtype)).to(cuda)
            bits = images.element_size() * 8
            rects = torch.from_numpy(pack_rects([[(1, 0, 2, 1)]] * shape[0])).to(cuda)
            res = fused_scrub_residuals(images, rects, sv=4)
            assert torch.equal(res, fused_ref(images, rects, 4, bits)), shape
            assert torch.equal(jls_residuals(images, sv=5), residuals_ref(images, 5, bits)), shape
            u, rs = entropy.rice_prepass(res)
            u_p, rs_p = entropy.rice_prepass_plain(res)
            assert torch.equal(u, u_p) and torch.equal(rs, rs_p), shape
            ks = torch.from_numpy(rng.integers(0, 31, size=shape[0]).astype(np.int32)).to(cuda)
            for a, b in zip(entropy.rice_len_rem(u, ks), entropy.rice_len_rem_plain(u, ks)):
                assert torch.equal(a, b), shape
    for shape, tile in (((65536, 1, 8), (1, 8)), ((1, 65537, 8), (1, 8))):
        images = torch.from_numpy(_full_range(rng, shape, np.uint8)).to(cuda)
        for got, want in zip(tile_profiles(images, thresh=100.0, tile=tile),
                             tile_profiles_torch(images, 100.0, tile)):
            assert torch.equal(got, want), shape
        got = phi_ops.edge_density(images, thresh=100.0, tile=tile)
        assert torch.equal(got, edge_density_ref(images, 100.0, tile)), shape
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", phi_cases.DTYPES)
@pytest.mark.parametrize("shape", phi_cases.SHAPES)
@pytest.mark.parametrize("offset", phi_cases.OFFSETS)
def test_phi_detect_kernel_equals_plain_version_at_chunk_edges(rng, cuda, dtype, shape, offset):
    """The kernel's 16-byte chunks and right-neighbour shuffles against the
    layouts of ``kernels/phi_detect/cases.py``: the audit's one-image
    shapes and a 32-image batch, ragged right and bottom edges, a base off
    a 16-byte boundary, tiles that are no vector multiple, every pixel
    type, the float32 threshold straddle and thresh 0; exact."""
    N, H, W = shape
    images = torch.from_numpy(phi_cases.planes(rng, dtype, shape)).to(cuda)[offset:offset + N]
    before = LAUNCHES["phi_detect"]
    for tile in phi_cases.TILES:
        for thresh in phi_cases.threshes(dtype):
            got = phi_ops.edge_density(images, thresh=thresh, tile=tile)
            assert torch.equal(got, edge_density_ref(images, thresh, tile)), (tile, thresh)
    torch.cuda.synchronize()
    assert LAUNCHES["phi_detect"] - before == len(phi_cases.TILES) * len(phi_cases.threshes(dtype))


@pytest.mark.parametrize("stack", ["CT", "DX", "US", "small", "H=1", "W=1", "W=257"])
@pytest.mark.parametrize("sv", list(range(1, 8)))
def test_jls_kernel_equals_plain_version(rng, cuda, stack, sv):
    """The CT chunk, the DX and US stacks of the main path, a ragged small
    stack and the edges; uint16 full range (samples >= 32768)."""
    shape, dtype = {
        "CT": ((32, 512, 512), np.uint16), "DX": ((4, 2500, 2048), np.uint16),
        "US": ((32, 540, 720), np.uint8), "small": ((2, 70, 90), np.uint16),
        "H=1": ((3, 1, 300), np.uint8), "W=1": ((3, 70, 1), np.uint16),
        "W=257": ((2, 9, 257), np.uint16),
    }[stack]
    images = torch.from_numpy(_full_range(rng, shape, dtype)).to(cuda)
    before = LAUNCHES["jls"]
    got = jls_residuals(images, sv=sv)
    torch.cuda.synchronize()
    assert LAUNCHES["jls"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, residuals_ref(images, sv, images.element_size() * 8))


@pytest.mark.parametrize("dtype", fused_cases.DTYPES)
@pytest.mark.parametrize("shape", fused_cases.SHAPES)
@pytest.mark.parametrize("offset", fused_cases.OFFSETS)
def test_jls_kernel_equals_plain_version_at_chunk_edges(rng, cuda, dtype, shape, offset):
    """jls runs fused's strip walker without rects: the layouts of
    ``kernels/fused/cases.py`` (ragged rows and bases off 16 bytes take the
    pixel path), every sv, and bits below the item size; exact."""
    N, H, W = shape
    images = torch.from_numpy(fused_cases.planes(rng, dtype, shape)).to(cuda)[offset:offset + N]
    bits = images.element_size() * 8
    before = LAUNCHES["jls"]
    for sv in fused_cases.SVS:
        for b in (bits, bits - 3):
            got = jls_residuals(images, sv=sv, bits=b)
            assert torch.equal(got, residuals_ref(images, sv, b)), (sv, b)
    torch.cuda.synchronize()
    assert LAUNCHES["jls"] - before == 2 * len(fused_cases.SVS)


def test_jls_kernel_refuses_what_it_cannot_run(cuda):
    images = torch.zeros((1, 4, 4), dtype=torch.uint16, device=cuda)
    for kw in ({"sv": 0}, {"sv": 8}):
        with pytest.raises(ValueError, match="selection value"):
            jls_residuals(images, **kw)
    with pytest.raises(ValueError, match="jls"):
        jls_residuals(images, bits=31)
    with pytest.raises(TypeError):
        jls_residuals(images.to(torch.int32))


def test_encodes_on_card_equal_host_codec(rng, cuda):
    from repro_torch.core.scrub import numpy_blank

    imgs = (rng.random((4, 96, 130)) * 4095).astype(np.uint16)
    before = dict(LAUNCHES)
    assert encode_batch(imgs) == [codec.encode(p, 1) for p in imgs]
    rl = [[(5, 5, 40, 12)], [], [(0, 0, 130, 8), (100, 50, 60, 60)], [(3, 90, 7, 7)]]
    assert fused_encode_batch(imgs, rl, sv=3) == [codec.encode(numpy_blank(p, r), 3)
                                                  for p, r in zip(imgs, rl)]
    assert LAUNCHES["jls"] == before["jls"] + 1 and LAUNCHES["fused"] == before["fused"] + 1


@pytest.mark.parametrize("recompress", [True, False])
def test_executor_kernel_path_equals_host_path(rng, cuda, recompress):
    items = _mk_items(rng, n=9)
    before = dict(LAUNCHES)

    def run(ex):
        return ex.run([(px.copy(), list(rl)) for px, rl in items], sv=2, recompress=recompress)

    ex = BatchedDeidExecutor(max_batch=4, pipeline_depth=3, device=cuda)
    outs = run(ex)
    ref = run(BatchedDeidExecutor(max_batch=4, use_kernel=False, device=cuda))
    assert ex.use_kernel is True
    assert [o.payload for o in outs] == [o.payload for o in ref]
    assert [o.pixels.tobytes() for o in outs] == [o.pixels.tobytes() for o in ref]
    names = ("fused", "rice_prepass", "rice_len_rem") if recompress else ("scrub",)
    assert all(LAUNCHES[k] > before[k] for k in names)


@pytest.mark.parametrize("modality", ["CT", "US"])
def test_pipeline_on_card_equals_host_path(cuda, modality):
    study = StudyGenerator(seed=5).gen_study(f"GPU-{modality}", modality=modality, n_images=5)
    pseudo = PseudonymService("IRB-G", TrustMode.POST_IRB, key=b"g" * 32)
    req = build_request(pseudo, study.accession, study.mrn)
    card = DeidPipeline()
    host = DeidPipeline(device=cuda)
    host.executor.use_kernel = False
    got, want = card.process_study(study, req), host.process_study(study, req)
    assert card.executor.use_kernel is True
    assert got[1].to_json() == want[1].to_json()
    for a, b in zip(got[0], want[0]):
        assert a.elements == b.elements and np.array_equal(a.pixels, b.pixels)


@pytest.mark.parametrize("tile", [(32, 128), (16, 64), (24, 100)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("thresh", [2457.0001, 0.0])
def test_detector_kernels_equal_plain_versions(rng, cuda, tile, dtype, thresh):
    """Ragged H and W (the kernels read zeros past the frame), the float32
    threshold straddle, and hits in the padding at thresh <= 0."""
    if dtype == np.float32:
        imgs = rng.random((3, 70, 300)).astype(np.float32) * 4000
    else:
        imgs = _full_range(rng, (3, 70, 300), dtype)
    imgs[:, :, -1] = 255 if dtype == np.uint8 else 2457
    images = torch.from_numpy(imgs).to(cuda)
    before = dict(LAUNCHES)
    for got, want in zip(tile_profiles(images, thresh=thresh, tile=tile),
                         tile_profiles_torch(images, thresh, tile)):
        assert torch.equal(got, want)
    got = phi_ops.edge_density(images, thresh=thresh + 1000.0, tile=tile)
    assert torch.equal(got, edge_density_ref(images, thresh + 1000.0, tile))
    torch.cuda.synchronize()
    assert LAUNCHES["textdetect"] - before["textdetect"] == 1
    assert LAUNCHES["phi_detect"] - before["phi_detect"] == 1


def test_detector_kernels_refuse_oversized_tile(cuda):
    """A tile wider than 1024 was refused; both detector kernels now take
    any tile: (32, 2048), equal to the plain versions."""
    images = torch.zeros((2, 64, 4100), dtype=torch.uint8, device=cuda)
    images[:, 3, :] = 255
    images[:, 9, 100:3000:3] = 255
    images[1, 20, 17:2100] = 255
    for got, want in zip(tile_profiles(images, thresh=1.0, tile=(32, 2048)),
                         tile_profiles_torch(images, 1.0, (32, 2048))):
        assert torch.equal(got, want)
    got = phi_ops.edge_density(images, thresh=1.0, tile=(32, 2048))
    assert torch.equal(got, edge_density_ref(images, 1.0, (32, 2048)))


def test_registry_first_pipeline_on_card_equals_host_path(cuda):
    gen = StudyGenerator(seed=5)
    study = gen.gen_study("GPU-UCT", device=gen.unknown_device("GPU-UCT", "CT"), n_images=18)
    pseudo = PseudonymService("IRB-G", TrustMode.POST_IRB, key=b"g" * 32)
    req = build_request(pseudo, study.accession, study.mrn)
    before = LAUNCHES["textdetect"]
    card = DeidPipeline(detector_policy=DetectorPolicy())
    host = DeidPipeline(detector_policy=DetectorPolicy(), device=cuda)
    host.executor.use_kernel = False
    got, want = card.process_study(study, req), host.process_study(study, req)
    assert LAUNCHES["textdetect"] > before
    assert card.scrub.detect_stats.detector_runs == 18
    assert card.scrub.detect_stats.detected == host.scrub.detect_stats.detected > 0
    assert got[1].to_json() == want[1].to_json()
    for a, b in zip(got[0], want[0]):
        assert a.elements == b.elements and np.array_equal(a.pixels, b.pixels)
        assert phi_ops.audit_dataset(a) is phi_ops.audit_dataset(a, device="cpu") is False


def _leaves(rng, n, k, device):
    masks = [rng.random(n) < rng.random() for _ in range(k)] + [rng.random(n) < 0.9]
    return torch.stack([pack_mask(torch.from_numpy(m).to(device)) for m in masks])


@pytest.mark.parametrize("n", [1, 33, 1000, (1 << 16) - 5, (1 << 22) - 5])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_bitmap_kernel_equals_plain_version(rng, cuda, n, k):
    """Ragged row counts (the last word's tail bits) under a program with
    NOTs, ORs and the final validity AND; counts exact."""
    leaves = _leaves(rng, n, k, cuda)
    prog = [("leaf", 0)]
    for i in range(1, k):
        prog += [("leaf", i)] + ([("not",)] if i % 2 else []) + [("or",) if i % 3 else ("and",)]
    prog = tuple(prog) + (("not",), ("leaf", k), ("and",))
    before = LAUNCHES["bitmap"]
    got, count = combine_bitmaps(leaves, prog)
    want, want_count = combine_bitmaps_torch(leaves, prog)
    torch.cuda.synchronize()
    assert LAUNCHES["bitmap"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want) and count == int(want_count)
    ref, ref_count = combine_bitmaps_ref(leaves.cpu().numpy().view(np.uint32), prog)
    assert np.array_equal(got.cpu().numpy().view(np.uint32), ref) and count == ref_count


@pytest.mark.parametrize("n", [5, 32, 1000, 4097])
def test_bitmap_not_rooted_program_never_counts_padding(cuda, n):
    leaves = torch.stack([pack_mask(torch.zeros(n, dtype=torch.bool, device=cuda)),
                          pack_mask(torch.ones(n, dtype=torch.bool, device=cuda))])
    prog = (("leaf", 0), ("not",), ("leaf", 1), ("and",))
    _, count = combine_bitmaps(leaves, prog)
    assert count == n == int(combine_bitmaps_torch(leaves, prog)[1])


def test_bitmap_kernel_refuses_programs_it_cannot_run(cuda):
    """Only malformed programs are refused (``ValueError``), by the wrapper's
    scheduler and by the C entry point itself; programs longer or deeper
    than one launch takes run, equal to the plain version."""
    max_ops, max_depth = program_limits()
    leaves = _leaves(np.random.default_rng(2), 1000, 1, cuda)
    malformed = ((("leaf", 2),), (("leaf", 0), ("and",)), (("leaf", 0), ("leaf", 1)),
                 (("leaf", 0), ("xor",)))
    for prog in malformed:
        with pytest.raises(ValueError, match="bitmap"):
            combine_bitmaps(leaves, prog)
    fn = bind("bitmap", "bitmap_combine_launch", 5, 3)
    out = torch.empty(leaves.shape[1], dtype=torch.int32, device=cuda)
    too_long_for_one = (("leaf", 0),) + (("not",),) * max_ops
    too_deep_for_one = (("leaf", 0),) * (max_depth + 1) + (("and",),) * max_depth
    for prog in malformed + (too_long_for_one, too_deep_for_one):
        ops = (ctypes.c_int * len(prog))(*[OPCODES.get(op[0], -1) for op in prog])
        args = (ctypes.c_int * len(prog))(*[op[1] if op[0] == "leaf" else 0 for op in prog])
        rc = fn(leaves.data_ptr(), out.data_ptr(), None, ops, args, 2, leaves.shape[1], len(prog),
                torch.cuda.current_stream().cuda_stream)
        assert rc == 1, prog[:3]  # cudaErrorInvalidValue
    # a launch of max_ops ops holds at most (max_ops + 1) // 2 leaf ops, which
    # the scheduler's order keeps within the kernel's depth
    assert math.floor(math.log2((max_ops + 1) // 2)) + 1 <= max_depth
    for prog in (too_long_for_one, too_deep_for_one, (("leaf", 0),) + (("not",),) * (max_ops - 1)):
        got, count = combine_bitmaps(leaves, prog)
        want, want_count = combine_bitmaps_torch(leaves, prog)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and count == int(want_count), len(prog)


@pytest.mark.parametrize("n_ops", [65, 1000, 5000])
@pytest.mark.parametrize("n", [1000, 4097 * 32, 1 << 20])
def test_bitmap_kernel_takes_long_programs(rng, cuda, n_ops, n):
    """Programs of any length through the scheduler: one launch up to
    ``program_limits()`` ops, else one for each cut subtree, scratch rows
    between them; 16- and 4-byte paths; exact against the plain version and
    the numpy oracle."""
    leaves = _leaves(rng, n, 8, cuda)
    prog = bitmap_cases.random_program(rng, n_ops, 8)
    max_ops, _ = program_limits()
    before = LAUNCHES["bitmap"]
    got, count = combine_bitmaps(leaves, prog)
    want, want_count = combine_bitmaps_torch(leaves, prog)
    torch.cuda.synchronize()
    assert LAUNCHES["bitmap"] - before == len(schedule_program(prog, max_ops, 9))
    assert (LAUNCHES["bitmap"] - before == 1) == (len(prog) <= max_ops)
    assert torch.equal(got, want) and count == int(want_count)
    ref, ref_count = combine_bitmaps_ref(leaves.cpu().numpy().view(np.uint32), prog)
    assert np.array_equal(got.cpu().numpy().view(np.uint32), ref) and count == ref_count


def _nested_query(depth):
    q = Range("study_date", 20150101, 20190101)
    for d in range(depth):
        q = (And if d % 2 else Or)(In("modality", ["CT", "MR", "DX", "US"][d % 4:d % 4 + 2]), q)
    return q


def test_catalog_on_card_answers_long_and_deep_queries(cuda):
    """A 40-child And and a 40-deep And/Or nesting through
    ``StudyCatalog.select`` on the card, equal to the oracle."""
    cat = StudyCatalog(block_rows=64, device=cuda)
    mods = ["CT", "MR", "DX", "US"]
    for i in range(40):
        cat.ingest_rows(f"G{i:03d}", [
            {"modality": mods[(i + j) % 4], "model": f"M{j % 3}", "study_date": 20150101 + i * 100,
             "rows": 512, "cols": 512, "nbytes": 1000 + j} for j in range(25)], etag=f"e{i}")
    wide = And(*[Range("study_date", 20150101 + 10 * i, 20190101) if i % 2 else
                 In("modality", [m for m in mods if m != mods[i % 4]]) for i in range(40)])
    for q in (wide, _nested_query(40)):
        before = LAUNCHES["bitmap"]
        got, want = cat.select(q), cat.select(q, mode="oracle")
        assert LAUNCHES["bitmap"] > before
        assert got == want and got.total_instances > 0


def test_catalog_on_card_equals_oracle(rng, cuda):
    cat = StudyCatalog(block_rows=64, device=cuda)
    mods = ["CT", "MR", "DX", "US"]
    for i in range(40):
        cat.ingest_rows(f"G{i:03d}", [
            {"modality": mods[(i + j) % 4], "model": f"M{j % 3}", "study_date": 20150101 + i * 100,
             "rows": 512, "cols": 512, "nbytes": 1000 + j} for j in range(25)], etag=f"e{i}")
    for q in (Range("study_date", 20150101, 20150801),
              And(In("modality", ["CT", "DX"]), Not(Contains("model", "1")))):
        before = LAUNCHES["bitmap"]
        got, want = cat.select(q), cat.select(q, mode="oracle")
        assert LAUNCHES["bitmap"] == before + 1
        assert got == want and got.total_instances > 0


# ------------------------------------- the scenario suite, the fleet, the farm
def test_feature_files_on_card_equal_cpu(cuda):
    from pathlib import Path

    from repro_torch.core.scenarios import VirtualDicomTree, parse_feature, run_feature

    for path in sorted((Path(__file__).parent / "features").glob("*.feature")):
        feature = parse_feature(path.read_text())
        before = LAUNCHES["scrub"]
        card = run_feature(feature, VirtualDicomTree(), device=cuda)
        assert LAUNCHES["scrub"] > before
        cpu = run_feature(feature, VirtualDicomTree(), device="cpu")
        assert all(r.passed for r in card), [(r.scenario, r.detail) for r in card]
        assert [(r.scenario, r.passed, r.detail) for r in card] == [
            (r.scenario, r.passed, r.detail) for r in cpu]


def _fleet(device, path):
    from repro_torch.sim import BurstyTraffic, ChaosSchedule, FleetConfig, FleetSim, QueryMix

    corpus = [f"SIM{i:04d}" for i in range(4)]
    cfg = FleetConfig(seed=7, n_studies=4, images_per_study=1, modality=None, recompress=True,
                      unknown_device_rate=0.25, feed_mutations=4)
    traffic = (BurstyTraffic(n_bursts=2, cohorts_per_burst=2, cohort_size=2).schedule(corpus, 7)
               + QueryMix(n_queries=3).schedule(corpus, 7))
    chaos = ChaosSchedule.seeded(7, 1800.0, corpus, crash_events=2, straggler_events=1,
                                 reingests=2, lease_storms=1, ruleset_edits=1, pooler_crashes=1,
                                 feed_outages=1, feed_faults=1)
    sim = FleetSim(cfg, traffic, path, chaos, device=device)
    return sim, sim.run()


def test_fleet_on_card_equals_cpu(cuda, tmp_path):
    """A short fleet run on the card: green, and its event-log and audit
    digests and metrics equal the same run on the CPU; so does its trace
    digest, once the executor spans' path labels read as the host path's."""
    from repro_torch.obs.trace import host_path_digest

    before = dict(LAUNCHES)
    card_sim, card = _fleet(cuda, tmp_path / "card.jsonl")
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    cpu_sim, cpu = _fleet("cpu", tmp_path / "cpu.jsonl")
    assert card.ok(), [v.detail for v in card.violations]
    assert (card.log_digest, card.audit["digest"], card.metrics) == (
        cpu.log_digest, cpu.audit["digest"], cpu.metrics)
    assert host_path_digest(card_sim.tracer.spans()) == cpu.trace_digest
    assert host_path_digest(cpu_sim.tracer.spans()) == cpu.trace_digest
    for k in ("fused", "rice_prepass", "rice_len_rem", "bitmap"):
        assert launched[k] > 0, k
    assert (launched["textdetect"] > 0) == (card.metrics["detector_runs"] > 0)


def test_scrub_farm_over_every_card_equals_numpy_blank(rng, cuda):
    from repro_torch.core.scrub import numpy_blank
    from repro_torch.distributed import ScrubFarm

    farm = ScrubFarm()
    assert farm.n == torch.cuda.device_count()
    for n in (1, 7, 3 * farm.n + 1):
        imgs = (rng.random((n, 64, 128)) * 4000).astype(np.uint16)
        rl = [[(0, 0, 128, 8), (int(rng.integers(100)), int(rng.integers(50)), 20, 10)]
              for _ in range(n)]
        before = LAUNCHES["scrub"]
        out = farm.scrub_batch(imgs, rl)
        assert LAUNCHES["scrub"] == before + farm.n
        assert np.array_equal(out, np.stack([numpy_blank(imgs[i], rl[i]) for i in range(n)]))
    gen = StudyGenerator(seed=11)
    datasets = [ds for m in ("CT", "DX", "US") for ds in gen.gen_study(f"F-{m}", modality=m,
                                                                        n_images=2).datasets
                if ds.pixels is not None]
    raw = [ds.pixels.copy() for ds in datasets]
    applied = farm.process_datasets(datasets, DeidPipeline(recompress=False, device="cpu").scrub.rects_for)
    assert applied
    for i, ds in enumerate(datasets):
        assert np.array_equal(ds.pixels, numpy_blank(raw[i], applied[i]) if i in applied else raw[i])


def test_elastic_farm_over_every_card_equals_numpy_blank(rng, cuda):
    """The elastic controller over the host's cards: the farm on all of
    them, then rebuilt around a failed one, each equal to numpy_blank."""
    from repro_torch.core.scrub import numpy_blank
    from repro_torch.distributed import ElasticFarmController

    c = ElasticFarmController()
    n = len(c.pool)
    assert n == torch.cuda.device_count()
    imgs = (rng.random((2 * n + 3, 64, 128)) * 4000).astype(np.uint16)
    rl = [[(0, 0, 128, 8), (int(rng.integers(100)), int(rng.integers(50)), 20, 10)]
          for _ in range(len(imgs))]
    ref = np.stack([numpy_blank(imgs[i], rl[i]) for i in range(len(imgs))])
    assert np.array_equal(c.reconcile(n).scrub_batch(imgs, rl), ref)
    assert c.active == n
    c.mark_failed(n - 1)
    assert c.active == max(n - 1, 1)
    assert np.array_equal(c.reconcile(n).scrub_batch(imgs, rl), ref)


def test_scrub_farm_default_raises_without_cuda(monkeypatch):
    from repro_torch.distributed import ElasticFarmController, ScrubFarm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ScrubFarm()
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticFarmController()


# ------------------------------------------------------------ LM serving
LM_SERVE_ARCHS = ["qwen2-0.5b", "h2o-danube-1.8b", "mixtral-8x22b", "olmoe-1b-7b",
                  "falcon-mamba-7b", "zamba2-2.7b"]
LM_TOL = dict(atol=1e-4, rtol=1e-4)  # reduced configs, f32 activations, TF32 off


def _lm_pair(cfg, cuda, seed=0):
    """The same weights on the CPU and on the card."""
    import copy

    from repro_torch.models import build_model

    cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(seed))
    return cpu, copy.deepcopy(cpu).to(cuda)


def _lm_prompt(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        return {"frame_embeds": rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16 if cfg.family == "vlm" else 32))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return batch


def _lm_serve(model, prompts, max_new, max_batch):
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(model, max_batch=max_batch)
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        eng.submit(Request(f"r{i}", p, max_new_tokens=m))
    return [r.tokens for r in eng.run()]


@pytest.mark.parametrize("arch", LM_SERVE_ARCHS + ["llava-next-34b", "hubert-xlarge"])
def test_lm_reduced_on_card_equals_cpu(cuda, arch):
    from repro_torch.config import get_arch
    from repro_torch.kernels import LAUNCHES

    before = dict(LAUNCHES)
    cfg = get_arch(arch).reduced()
    cpu, card = _lm_pair(cfg, cuda)
    batch = _lm_prompt(cfg, seed=1)
    lc, _ = cpu.prefill(batch)
    lg, _ = card.prefill(batch)
    assert lg.device == cuda
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), **LM_TOL)
    if arch in LM_SERVE_ARCHS:  # llava and hubert: prefill logits only
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (64, 17, 40, 33, 64, 8)]
        max_new = [12, 12, 5, 12, 7, 12]
        assert _lm_serve(card, prompts, max_new, 3) == _lm_serve(cpu, prompts, max_new, 3)
    # the LM path launches the decode-attention kernel, where a served step
    # attends, and none of the port's other kernels
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    attends = arch in LM_SERVE_ARCHS and cfg.family != "ssm"
    assert (launched.pop("decode_attn") > 0) == attends and not any(launched.values()), launched


def test_lm_full_width_f32_prefill_on_card_equals_cpu(cuda):
    import dataclasses

    from repro_torch.config import get_arch

    cfg = dataclasses.replace(get_arch("qwen2-0.5b"), dtype="float32")
    cpu, card = _lm_pair(cfg, cuda, seed=3)
    assert sum(p.numel() for p in card.parameters()) == cfg.param_count()
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 64))
    lc, cc = cpu.prefill({"tokens": tokens})
    lg, cg = card.prefill({"tokens": tokens})
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), atol=1e-3, rtol=1e-3)
    for name in ("k", "v"):
        np.testing.assert_allclose(cg[name].cpu().numpy(), cc[name].numpy(), atol=1e-3, rtol=1e-3)


def test_lm_falcon_mamba_batch_equal_to_prompt_length_on_card(cuda):
    from repro_torch.config import get_arch

    cfg = get_arch("falcon-mamba-7b").reduced()
    cpu, card = _lm_pair(cfg, cuda)
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16]]
    want = _lm_serve(cpu, prompts, [3] * 4, 2)
    assert _lm_serve(card, prompts, [3] * 4, 4) == want  # B == P
    assert _lm_serve(cpu, prompts, [3] * 4, 4) == want


def test_lm_defaults_to_the_card(cuda, monkeypatch):
    from repro_torch.config import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeEngine

    cfg = get_arch("qwen2-0.5b").reduced()
    model = build_model(cfg)
    assert model.device == torch.device("cuda:0")
    assert all(p.device == torch.device("cuda:0") for p in model.parameters())
    eng = ServeEngine(model, max_batch=2)
    eng.submit(Request("r0", [1, 2, 3], max_new_tokens=4, temperature=0.8))
    eng.submit(Request("r1", [4, 5, 6], max_new_tokens=4))
    assert [len(r.tokens) for r in eng.run()] == [4, 4]  # samples with a generator on the card
    assert serve.main(["--requests", "2", "--max-new", "3"])["device"] == "cuda:0"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])


# -------------------------------------------------- the decode CUDA graph
def _graph_prefill(model, B, P, total, seed):
    """A prefilled cache of B prompts of P tokens grown to ``total``
    positions (into the decode cache the model holds for the shape, if it
    holds one), and the first greedy tokens."""
    tokens = np.random.default_rng(seed).integers(1, model.cfg.vocab_size, (B, P))
    logits, cache = model.prefill({"tokens": tokens})
    return model.grow_cache(cache, P, total), logits.argmax(-1)


def _decode_paths(model):
    return model.decode_graphs_captured, model.decode_steps_replayed, model.decode_steps_eager


def _reduced_on(device, arch="qwen2-0.5b"):
    from repro_torch.config import get_arch
    from repro_torch.models import build_model

    return build_model(get_arch(arch).reduced(), device, generator=torch.Generator(device).manual_seed(0))


@torch.no_grad()
def test_decode_graph_replays_bitwise_as_eager_at_full_width(cuda):
    """qwen2-0.5b at its widths in bf16, batch 4, a 300-token horizon: 20
    steps through the graph (one capture, 19 replays) against the same steps
    of ``_decode_step`` called directly, bit for bit in logits and caches,
    the decode-attention kernel launched by the capture and replayed by the
    graph; a second cache shape captures a second graph."""
    from repro_torch.config import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.model import DECODE_GRAPH_MIN_NEW

    model = build_model(get_arch("qwen2-0.5b"), cuda, generator=torch.Generator(cuda).manual_seed(0))
    P = 256
    cache, tok = _graph_prefill(model, 4, P, 300, seed=5)
    eager = {name: t.clone() for name, t in cache.items()}
    first = None
    for step in range(20):
        before = LAUNCHES["decode_attn"]
        got, cache = model.decode_step(tok, cache, P + step)
        # the capture's eager run and its recording each launch the
        # decode-attention kernel once a layer; a replay launches it through
        # the graph, with no count on the host
        assert LAUNCHES["decode_attn"] - before == (2 * model.cfg.n_layers if step == 0 else 0), step
        want, eager = model._decode_step(tok, eager, P + step)
        assert torch.equal(got, want), step
        assert all(torch.equal(cache[n], eager[n]) for n in ("k", "v")), step
        if first is None:
            first, first_value = got, got.clone()
        tok = want.argmax(-1)
    assert torch.equal(first, first_value)  # a later step did not overwrite the logits returned
    assert _decode_paths(model) == (1, 19, 0)

    other, tok = _graph_prefill(model, 2, 64, 64 + DECODE_GRAPH_MIN_NEW, seed=6)
    eager = {name: t.clone() for name, t in other.items()}
    for step in range(2):
        got, other = model.decode_step(tok, other, 64 + step)
        want, eager = model._decode_step(tok, eager, 64 + step)
        assert torch.equal(got, want)
        tok = want.argmax(-1)
    assert _decode_paths(model) == (2, 20, 0) and len(model._decode_graphs) == 2


@torch.no_grad()
def test_decode_graph_past_the_bound_releases_the_oldest(cuda):
    """Past ``DECODE_GRAPHS`` shapes the least recently used cache goes with
    its graph: a step on the released cache runs eagerly, and the shape asked
    for again gets a new cache and a new capture."""
    import gc
    import weakref

    from repro_torch.models.model import DECODE_GRAPH_MIN_NEW, DECODE_GRAPHS

    model = _reduced_on(cuda)
    caches = []
    for i in range(DECODE_GRAPHS + 1):
        caches.append(_graph_prefill(model, 2, 16, 16 + DECODE_GRAPH_MIN_NEW + i, seed=i))
        model.decode_step(caches[-1][1], caches[-1][0], 16)
        if i == 0:
            oldest = weakref.ref(next(iter(model._decode_graphs.values())))
    gc.collect()
    assert oldest() is None and len(model._decode_graphs) == DECODE_GRAPHS
    assert _decode_paths(model) == (DECODE_GRAPHS + 1, 0, 0)
    cache, tok = caches[0]
    model.decode_step(tok, cache, 17)  # no longer the model's: eager
    again, tok = _graph_prefill(model, 2, 16, 16 + DECODE_GRAPH_MIN_NEW, seed=0)
    assert again["k"] is not cache["k"]
    model.decode_step(tok, again, 16)
    assert _decode_paths(model) == (DECODE_GRAPHS + 2, 0, 1)


@pytest.mark.parametrize("where", ["ssm on the card", "dense on the CPU", "dense, a cache of its own",
                                   "dense, a short horizon"])
@torch.no_grad()
def test_decode_graph_engages_only_for_dense_on_one_card(cuda, where, monkeypatch):
    """The graph takes a dense model's step on a cache the model holds, on
    the card; an SSM, the CPU, a cache the model does not hold, or a batch
    of fewer new positions than a capture repays decode eagerly and hold no
    cache."""
    from repro_torch.models.model import DECODE_GRAPH_MIN_NEW

    model = _reduced_on(torch.device("cpu") if "CPU" in where else cuda,
                        "falcon-mamba-7b" if where.startswith("ssm") else "qwen2-0.5b")
    total = 16 + (DECODE_GRAPH_MIN_NEW - 1 if "short" in where else DECODE_GRAPH_MIN_NEW)
    cache, tok = _graph_prefill(model, 2, 16, total, seed=1)
    if "of its own" in where:
        logits, own = model.prefill({"tokens": np.random.default_rng(1).integers(1, 100, (2, 16))})
        monkeypatch.setattr(model, "_held_cache", lambda *a: None)
        cache, tok = model.grow_cache(own, 16, total), logits.argmax(-1)
    for step in range(3):
        logits, cache = model.decode_step(tok, cache, 16 + step)
        tok = logits.argmax(-1)
    held = len(model._decode_graphs)
    assert _decode_paths(model) == (0, 0, 3) and held == ("of its own" in where)


@torch.no_grad()
def test_decode_graph_on_a_card_other_than_the_current(cuda):
    """A model on the last card, the current device left at the first: the
    graph is captured and replayed on the model's card, bit for bit as the
    eager step there."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.models.model import DECODE_GRAPH_MIN_NEW

    card = torch.device(f"cuda:{n - 1}")
    assert torch.cuda.current_device() == 0
    model = _reduced_on(card)
    cache, tok = _graph_prefill(model, 2, 16, 16 + DECODE_GRAPH_MIN_NEW, seed=3)
    eager = {name: t.clone() for name, t in cache.items()}
    for step in range(5):
        got, cache = model.decode_step(tok, cache, 16 + step)
        want, eager = model._decode_step(tok, eager, 16 + step)
        assert got.device == card and torch.equal(got, want), step
        assert all(torch.equal(cache[n], eager[n]) for n in ("k", "v")), step
        tok = want.argmax(-1)
    assert _decode_paths(model) == (1, 4, 0) and torch.cuda.current_device() == 0


@torch.no_grad()
def test_decode_graph_serves_as_eager_engine(cuda, monkeypatch):
    """``ServeEngine`` on the card: two batches of one shape, then one of
    another, decode through the held caches' graphs (two captures) and give
    the greedy tokens of the same model served eagerly (no held cache)."""
    import copy

    from repro_torch.models.model import DECODE_GRAPH_MIN_NEW
    from repro_torch.serving import Request, ServeEngine

    model = _reduced_on(cuda)
    twin = copy.deepcopy(model)
    monkeypatch.setattr(twin, "_held_cache", lambda *a: None)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, model.cfg.vocab_size, n).tolist() for n in (40, 17, 40, 33, 40, 8, 9, 5)]
    max_new = [DECODE_GRAPH_MIN_NEW] * 6 + [DECODE_GRAPH_MIN_NEW + 3] * 2

    def serve(m, batch):
        eng = ServeEngine(m, max_batch=batch)
        for i, (p, k) in enumerate(zip(prompts, max_new)):
            eng.submit(Request(f"r{i}", p, max_new_tokens=k))
        return [r.tokens for r in eng.run()]

    assert serve(model, 3) == serve(twin, 3)
    steps = 2 * (DECODE_GRAPH_MIN_NEW - 1) + DECODE_GRAPH_MIN_NEW + 2
    assert _decode_paths(model) == (2, steps - 2, 0) and _decode_paths(twin) == (0, 0, steps)
    assert sorted(model._decode_graphs) == [(2, 9 + DECODE_GRAPH_MIN_NEW + 3), (3, 40 + DECODE_GRAPH_MIN_NEW)]


# --------------------------------------------- the decode-attention kernel
@pytest.mark.parametrize("case", list(DECODE_ATTN_CASES))
@torch.no_grad()
def test_decode_attn_kernel_equals_plain_version_and_oracle(cuda, case):
    """The kernel against ``_decode_core`` on the card and against a float64
    oracle of the same formula, within a share of the largest output (the
    limit's reasons and its planted faults: ``tests/test_torch_decode_attn.py``);
    a wrong KV head or the mean of V misses it by far at this case's inputs;
    two calls give the same bits, and so does ``pos`` read from a 0-d tensor
    on the card (a captured step's)."""
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.models.attention import _decode_core

    B, S, KV, G, hd, dtype, pos, window, scale = DECODE_ATTN_CASES[case]
    scale = 1 / math.sqrt(hd) if scale is None else scale
    q, k, v = decode_attn_draw(B, S, KV, G, hd, dtype, scale, seed=len(case), device=cuda)
    before = LAUNCHES["decode_attn"]
    got = decode_attn(q, k, v, pos, window=window, scale=scale)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(decode_attn(q, k, v, pos, window=window, scale=scale), got)
    at = torch.tensor(pos, dtype=torch.int64, device=cuda)
    assert torch.equal(decode_attn(q, k, v, at, window=window, scale=scale), got)
    assert LAUNCHES["decode_attn"] - before == 3
    plain = _decode_core(q, k, v, pos, window, scale).to(dtype)
    tol = decode_attn_within_limit(got, plain, decode_attn_oracle(q, k, v, pos, window, scale))
    for name, wrong in decode_attn_faults(q, k, v, pos, window, scale).items():
        assert (wrong.float() - plain.float()).abs().max().item() > DECODE_ATTN_FAULT_MARGIN * tol, name


def test_decode_attn_kernel_refuses_what_it_cannot_run(cuda):
    from repro_torch.kernels.decode_attn.ops import decode_attn

    q, k, v = decode_attn_draw(2, 64, 2, 3, 32, torch.bfloat16, 0.25, seed=0, device=cuda)
    cut = [t[..., :24].contiguous() for t in (q, k, v)]
    with pytest.raises(ValueError, match="multiple of 16"):
        decode_attn(*cut, 5, window=0, scale=0.25)
    with pytest.raises(TypeError, match="one type"):
        decode_attn(q.float(), k, v, 5, window=0, scale=0.25)
    wide = torch.cat([k, k], dim=-1)[..., :32]
    with pytest.raises(ValueError, match="contiguous"):
        decode_attn(q, wide, wide, 5, window=0, scale=0.25)
    with pytest.raises(ValueError, match="one CUDA device"):
        decode_attn(q.cpu(), k, v, 5, window=0, scale=0.25)


# -------------------------------------------------------------- LM training
TRAIN_FAMILIES = ["qwen2-0.5b", "h2o-danube-1.8b", "olmoe-1b-7b", "falcon-mamba-7b", "zamba2-2.7b",
                  "llava-next-34b", "hubert-xlarge"]
TRAIN_TOL = dict(atol=1e-4, rtol=1e-4)  # losses, card against CPU (f32 activations, TF32 off)


def _train_pair(cfg, cuda, seed=0, compression=False):
    """The same weights and optimizer state on the CPU and on the card."""
    from repro_torch.training import train_state_init

    cpu, card = _lm_pair(cfg, cuda, seed)
    return [(m, train_state_init(m, compression=compression)) for m in (cpu, card)]


def _train_losses(model, state, batches, compression=False, microbatches=1, lr=1e-3, warmup=1):
    from repro_torch.training import cosine_schedule, make_train_step

    step = make_train_step(model, cosine_schedule(lr, warmup, 10), compression=compression,
                           microbatches=microbatches)
    losses, gnorms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    return state, losses, gnorms


def _flat(tree):
    from repro_torch.training.checkpoint import flatten_with_paths

    return flatten_with_paths(tree)


@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_train_reduced_on_card_equals_cpu(cuda, arch):
    """(m3) as a test: 3 steps of every family, card against CPU."""
    from repro_torch.config import get_arch
    from repro_torch.training import SyntheticTokenPipeline

    cfg = get_arch(arch).reduced()
    pipe = SyntheticTokenPipeline(cfg, 2, 32, seed=1)
    batches = [pipe.get_batch(i) for i in range(3)]
    before = dict(LAUNCHES)
    (mc, sc), (mg, sg) = _train_pair(cfg, cuda)
    _, want, _ = _train_losses(mc, sc, batches)
    _, got, _ = _train_losses(mg, sg, batches)
    np.testing.assert_allclose(got, want, **TRAIN_TOL)
    assert got[-1] < got[0]
    assert all(p.device == cuda for p in mg.parameters())
    assert dict(LAUNCHES) == before  # training launches none of the port's kernels


def test_train_full_width_f32_on_card_equals_cpu(cuda):
    """(m2) as a test: qwen2-0.5b at full width in f32, 4 layers, 2 steps of
    B 2 x S 128; loss and gnorm within 1e-4 relative, every weight's f32
    master within 1e-4 relative per leaf, the zero-initialised QKV biases
    (AdamW's normalised steps only) within 2 x the summed learning rate."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.training import SyntheticTokenPipeline

    cfg = dataclasses.replace(get_arch("qwen2-0.5b"), dtype="float32", n_layers=4)
    pipe = SyntheticTokenPipeline(cfg, 2, 128, seed=0)
    batches = [pipe.get_batch(i) for i in range(2)]
    (mc, sc), (mg, sg) = _train_pair(cfg, cuda, seed=2)
    sc, lc, gc = _train_losses(mc, sc, batches, lr=3e-4, warmup=5)
    sg, lg, gg = _train_losses(mg, sg, batches, lr=3e-4, warmup=5)
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    np.testing.assert_allclose(gg, gc, rtol=1e-4)
    # the f32 masters (the bf16 weights round them); the zero-initialised QKV
    # biases hold only AdamW's normalised steps: within 2 x the summed lr
    from repro_torch.models.spec import tree_items

    lr_sum = 0.0 + 3e-4 / 5
    zero_init = {k.replace(".", "/") for k, spec in tree_items(mg.param_specs()) if spec.init == "zeros"}
    assert zero_init == {"layers/attn/bq", "layers/attn/bk", "layers/attn/bv"}
    cpu_master = _flat(sc.opt.master)
    for key, p in _flat(sg.opt.master).items():
        diff = p.double().cpu() - cpu_master[key].double()
        if key in zero_init:
            assert float(diff.abs().max()) <= 2 * lr_sum, key
        else:
            assert float(torch.linalg.norm(diff) / torch.linalg.norm(cpu_master[key].double())) <= 1e-4, key


def test_train_microbatches_and_compression_on_card(cuda, tmp_path):
    from repro_torch.config import get_arch
    from repro_torch.launch import train
    from repro_torch.training import SyntheticTokenPipeline

    cfg = get_arch("qwen2-0.5b").reduced()
    batch = SyntheticTokenPipeline(cfg, 4, 64, seed=3).get_batch(1)
    losses = {}
    for n in (1, 2):
        _, (model, state) = _train_pair(cfg, cuda, seed=1)
        losses[n] = _train_losses(model, state, [batch], microbatches=n, warmup=0)[1][0]
    assert losses[2] == pytest.approx(losses[1], rel=1e-5)
    (mc, sc), (mg, sg) = _train_pair(cfg, cuda, seed=4, compression=True)
    pipe = SyntheticTokenPipeline(cfg, 2, 64, seed=2)
    batches = [pipe.get_batch(i) for i in range(3)]
    np.testing.assert_allclose(_train_losses(mg, sg, batches, compression=True)[1],
                               _train_losses(mc, sc, batches, compression=True)[1], **TRAIN_TOL)
    out = train.main(["--arch", "qwen2-0.5b", "--steps", "3", "--batch", "4", "--seq", "64",
                      "--compression", "--ckpt-dir", str(tmp_path)])
    assert out["device"] == "cuda:0" and math.isfinite(out["final_loss"])


def test_train_checkpoint_on_card(cuda, tmp_path):
    """(m4) as a test: save at step 2 on the card, restore into a fresh
    state bit for bit, 2 more steps equal to the uninterrupted run."""
    from repro_torch.config import get_arch
    from repro_torch.models import build_model
    from repro_torch.training import CheckpointManager, SyntheticTokenPipeline, train_state_init
    from repro_torch.training.checkpoint import flatten_with_paths

    cfg = get_arch("qwen2-0.5b").reduced()
    pipe = SyntheticTokenPipeline(cfg, 2, 64, seed=9)
    batches = [pipe.get_batch(i) for i in range(4)]

    def fresh(seed):
        model = build_model(cfg, cuda, generator=torch.Generator().manual_seed(seed))
        return model, train_state_init(model, compression=True)

    _, whole, _ = _train_losses(*fresh(5), batches, compression=True)
    model, state = fresh(5)
    state, first, _ = _train_losses(model, state, batches[:2], compression=True)
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, state)
    saved = {k: v.detach().clone() for k, v in flatten_with_paths(state).items()}
    other, template = fresh(77)
    restored, step, _ = mgr.restore(template)
    assert step == 2
    for k, v in flatten_with_paths(restored).items():
        assert v.device == cuda and torch.equal(v, saved[k]), k
    _, rest, _ = _train_losses(other, restored, batches[2:], compression=True)
    np.testing.assert_allclose(first + rest, whole, **TRAIN_TOL)


def test_train_defaults_to_the_card(cuda, tmp_path, monkeypatch):
    from repro_torch.launch import train

    out = train.main(["--arch", "qwen2-0.5b", "--steps", "2", "--batch", "2", "--seq", "32",
                      "--ckpt-dir", str(tmp_path)])
    assert out["device"] == "cuda:0" and math.isfinite(out["final_loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen2-0.5b", "--steps", "1", "--ckpt-dir", str(tmp_path / "x")])


# ----------------------------------------------------------- LM on a mesh
# every family reduced, placed on (data 1, model every card) by the port's
# sharding rules in a world of one NCCL rank a card (tests/torch_sharded.py)
SHARDED_FAMILIES = {"dense": "qwen2-0.5b", "sliding window": "h2o-danube-1.8b", "moe": "olmoe-1b-7b",
                    "ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b", "vlm": "llava-next-34b",
                    "encoder": "hubert-xlarge"}


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch_sharded import run_world

    n = torch.cuda.device_count()
    cases = {fam: {"arch": arch, "mesh": (1, n)} for fam, arch in SHARDED_FAMILIES.items()}
    return run_world(cases, n, tmp_path_factory.mktemp("mesh"), backend="nccl")


@pytest.mark.parametrize("family", list(SHARDED_FAMILIES))
def test_lm_on_a_mesh_of_the_cards_equals_unsharded(mesh_world, family):
    out = mesh_world[0][family]
    assert "error" not in out, out.get("error")
    assert out["prefill_err"] <= 1e-4
    if "tokens" in out:
        assert out["decode_err"] <= 1e-4 and out["tokens"] == out["ref_tokens"]
        assert out["gathered_params"] == []


@pytest.mark.parametrize("family", [f for f in SHARDED_FAMILIES if f not in ("vlm", "encoder")])
def test_lm_on_a_mesh_decodes_eagerly(mesh_world, family):
    """A placed model never takes the decode graph; its unsharded twin on
    the card takes it for its one step on a held cache in the dense and
    sliding-window families. (The mesh case serves no VLM or encoder.)"""
    out = mesh_world[0][family]
    assert "error" not in out, out.get("error")
    captured, replayed, eager = out["decode_paths"]["placed"]
    assert captured == replayed == 0 and eager > 0
    captured, replayed, eager = out["decode_paths"]["ref"]
    assert captured == (family in ("dense", "sliding window")) and replayed == 0 and eager > 0


# ------------------------------------------------ sharded training, dry-run
# the sharded train step on (data 1, model every card), FSDP on, against the
# same weights unsharded on the card (tests/torch_sharded_train.py); and
# chip_smoke's (o1) at a reduced size: the dry-run's traced peak of a train
# step (meta tensors on a cuda mesh) against the same step on the card
SHARDED_TRAIN = {"dense": "qwen2-0.5b", "moe": "olmoe-1b-7b", "ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b"}


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch_sharded_train import run_world

    n = torch.cuda.device_count()
    cases = {fam: {"kind": "train", "arch": arch, "mesh": (1, n)} for fam, arch in SHARDED_TRAIN.items()}
    return run_world(cases, n, tmp_path_factory.mktemp("train"), backend="nccl")


@pytest.mark.parametrize("family", list(SHARDED_TRAIN))
def test_sharded_train_step_on_the_cards_equals_one_card(train_world, family):
    out = train_world[0][family]
    assert "error" not in out, out.get("error")
    assert out["laid_out"]
    for got, want in zip(out["metrics"], out["ref_metrics"]):
        for key in ("loss", "gnorm"):
            assert abs(got[key] - want[key]) <= 1e-4 * max(1.0, abs(want[key])), (key, got, want)
    lr_sum = out["lr_sum"]
    for path, got in out["master"].items():
        want = out["ref_master"][path]
        err = np.abs(got - want)
        assert (err > 1e-4 + 1e-4 * np.abs(want)).sum() <= max(1, want.size // 10000), path
        assert (err <= 2 * lr_sum + 1e-4).all(), path


_DRYRUN_PEAK = """
import json, sys
import torch
from repro_torch.config import ShapeConfig, get_arch
from repro_torch.launch import dryrun, shardings as sh
from repro_torch.launch.act_sharding import activation_sharding
from repro_torch.launch.hlo_analysis import OpTrace
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.training import cosine_schedule, make_train_step, train_state_init
dryrun.start_world(1)
cfg = get_arch("qwen2-0.5b").reduced()
shape = ShapeConfig("train", 512, 8, "train")
mesh = make_mesh((1, 1), ("data", "model"), "cuda")
traced = dryrun.trace_cell(cfg, shape, mesh)
model = build_model(cfg, "cuda:0", generator=torch.Generator().manual_seed(0))
model = sh.place_model(model, sh.param_shardings(model, mesh))
state = train_state_init(model)
step = make_train_step(model, cosine_schedule(3e-4, 100, 10000))
batch = {k: model._input(torch.zeros(v.shape, dtype=v.dtype)) for k, v in model.input_specs(shape).items()}
with activation_sharding(sh.activation_rules(mesh, shape, cfg)):
    state, _ = step(state, batch)  # warm-up: cuBLAS workspace, allocator
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trace = OpTrace("cuda")
    with trace:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
print(json.dumps({"traced": traced["temp_size_in_bytes"], "op_trace": trace.peak,
                  "measured": torch.cuda.max_memory_allocated() - base}))
"""


def test_dry_run_peak_of_a_train_step_on_the_card(cuda):
    """The traced temporaries of a reduced qwen2 train step (B 8 x S 512)
    equal ``OpTrace``'s over the same step on the card, and are within 10 %
    of the card's ``max_memory_allocated`` over that step, less what was
    allocated before it (its arguments)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _DRYRUN_PEAK], capture_output=True, text=True, check=True,
                         env={**__import__("os").environ, "PYTHONPATH": str(root / "src")})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["traced"] == got["op_trace"] > 0
    assert abs(got["traced"] / got["measured"] - 1) <= 0.10, got


# ------------------------------------------- the dropless MoE's grouped GEMM
@pytest.mark.parametrize("counts", [[0, 5, 0, 17, 1, 0, 40, 3], [0] * 7 + [130], [1] * 72,
                                    [200, 0, 0, 300, 0, 1, 0, 64]])
@pytest.mark.parametrize("K,N", [(256, 192), (4096, 768), (768, 4096)])
def test_grouped_mm_on_card_equals_plain_version(cuda, counts, K, N):
    """The library's grouped GEMM on the card over ragged runs with empty
    experts, at the granite layer's shapes (gate/up K 4096 -> N 768, down
    K 768 -> N 4096) among others, with no host synchronisation. Both
    versions sum in float32 and round once to bf16, in other orders: they
    may land one bf16 step apart (2^-8 of the value), so rtol is two steps."""
    from repro_torch.models.moe import grouped_mm, grouped_mm_ref

    g = torch.Generator().manual_seed(len(counts) * 1000 + sum(counts) + K)
    E, M = len(counts), sum(counts)
    x = torch.randn(M, K, generator=g).to(torch.bfloat16)
    w = (torch.randn(E, K, N, generator=g) * K ** -0.5).to(torch.bfloat16)
    offsets = torch.tensor([0] + np.cumsum(counts).tolist(), dtype=torch.int64)
    xc, wc, oc = x.to(cuda), w.to(cuda), offsets.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = grouped_mm(xc, wc, oc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = grouped_mm_ref(x, w, offsets)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2 ** -7, atol=1e-3)


def _layered_reduced(dtype="bfloat16"):
    """The granite-4.0-h-small cut's ``reduced()`` stack in ``dtype``."""
    import dataclasses

    from repro_torch.config.model import LayeredConfig

    cut = LayeredConfig(
        name="granite-4.0-h-small", family="layered", n_layers=20, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=768, vocab_size=100352, head_dim=128, rope_theta=0.0, n_experts=72, experts_per_token=10,
        ssm_state=128, ssm_version=2, ssm_head_dim=64, ssm_chunk=256, tie_embeddings=True,
        layer_types=tuple(["mamba"] * 5 + ["attention"] + ["mamba"] * 9 + ["attention"] + ["mamba"] * 4),
        shared_d_ff=1536, embedding_multiplier=12.0, residual_multiplier=0.22, attn_scale=1 / 128,
        logits_scaling=16.0)
    return dataclasses.replace(cut.reduced(), dtype=dtype)


def test_layered_serves_on_card_as_on_cpu_without_host_syncs(cuda):
    """A reduced granite stack in bf16: prefill logits on the card (the
    library's grouped GEMM) against the CPU (the plain version) within bf16's
    rounding of a 4-layer stack (0.02 of logits whose spread is ~0.1: a few
    bf16 steps of the hidden states carried through the head); the decode
    steps make no host synchronisation (CUDA's sync debug mode raises on
    one) and route every pair."""
    cfg = _layered_reduced()
    cpu, card = _lm_pair(cfg, cuda)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 64))
    lc, cc = cpu.prefill({"tokens": tokens})
    lg, cg = card.prefill({"tokens": tokens})
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), atol=0.02, rtol=0)
    cache = card.grow_cache(cg, 64, 72)
    cur = lg.argmax(-1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in range(4):
            logits, cache = card.decode_step(cur, cache, 64 + step)
            cur = logits.argmax(-1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = card.moe_counters()
    assert counts["moe_pairs_dropped"] == 0
    assert counts["moe_pairs_routed"] == cfg.n_layers * cfg.experts_per_token * 2 * (64 + 4)
    assert counts["expert_gemm_calls"] == {"prefill": 3 * cfg.n_layers, "decode": 4 * 3 * cfg.n_layers}


@torch.no_grad()
def test_layered_decode_graph_replays_bitwise_as_eager_and_counts(cuda, monkeypatch):
    """The reduced granite stack in bf16, batch 4, prompt 64, a horizon of
    ``DECODE_GRAPH_MIN_NEW`` new positions: the steps on the cache the model
    holds (``ssm``, ``conv``, ``k``, ``v``) are captured once and replayed
    with no host synchronisation, and give the logits and caches of a twin
    that runs the same steps eagerly on a cache of its own, bit for bit (a
    state leaf advances once a step); the MoE counters read as the twin's."""
    import copy

    from repro_torch.models import build_model
    from repro_torch.models.model import DECODE_GRAPH_MIN_NEW

    cfg = _layered_reduced()
    model = build_model(cfg, cuda, generator=torch.Generator(cuda).manual_seed(0))
    twin = copy.deepcopy(model)
    monkeypatch.setattr(twin, "_held_cache", lambda *a: None)
    P, N = 64, DECODE_GRAPH_MIN_NEW
    tokens = np.random.default_rng(7).integers(1, cfg.vocab_size, (4, P))
    first, cache = model.prefill({"tokens": tokens})
    same, own = twin.prefill({"tokens": tokens})
    assert torch.equal(first, same)
    cache = model.grow_cache(cache, P, P + N)
    own = twin.grow_cache(own, P, P + N)
    (entry,) = model._decode_graphs.values()
    assert set(cache) == {"ssm", "conv", "k", "v"} and entry.holds(cache)
    got, want, tok = [], [], first.argmax(-1)
    try:
        for step in range(N):
            if step == 1:  # the replays
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            logits, cache = model.decode_step(tok, cache, P + step)
            eager, own = twin.decode_step(tok, own, P + step)
            got.append(logits)
            want.append(eager)
            tok = eager.argmax(-1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(cache[n], own[n]) for n in own)
    assert _decode_paths(model) == (1, N - 1, 0) and _decode_paths(twin) == (0, 0, N)
    counts = model.moe_counters()
    assert counts == twin.moe_counters()
    assert counts["expert_gemm_calls"]["decode"] == 3 * cfg.n_layers * N
    assert counts["expert_tokens"]["decode"] == 4 * cfg.n_layers * N
    assert counts["moe_pairs_routed"] == cfg.n_layers * cfg.experts_per_token * 4 * (P + N)
