"""The port's CUDA kernels and its kernel path on the card, held against the
plain PyTorch versions and the host path (exact).

Every test here is marked ``gpu`` and skips where no card is present. The
file imports nothing of JAX or of the JAX package, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.catalog import And, Contains, In, Not, Range, StudyCatalog
from repro_torch.core import DeidPipeline, PseudonymService, TrustMode, build_request
from repro_torch.core.batch import BatchedDeidExecutor
from repro_torch.detect import DetectorPolicy
from repro_torch.dicom.generator import StudyGenerator
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.bitmap.ops import (
    combine_bitmaps,
    combine_bitmaps_torch,
    pack_mask,
    program_limits,
)
from repro_torch.kernels.bitmap.ref import combine_bitmaps_ref
from repro_torch.dicom import codec
from repro_torch.kernels.fused.ops import fused_encode_batch, fused_scrub_residuals
from repro_torch.kernels.fused.ref import fused_ref
from repro_torch.kernels.jls import entropy
from repro_torch.kernels.jls.ops import encode_batch, jls_residuals
from repro_torch.kernels.jls.ref import residuals_ref
from repro_torch.kernels.phi_detect import ops as phi_ops
from repro_torch.kernels.phi_detect.ref import edge_density_ref
from repro_torch.kernels.scrub.ops import pack_rects, scrub_images
from repro_torch.kernels.scrub.ref import scrub_ref
from repro_torch.kernels.textdetect.ops import tile_profiles
from repro_torch.kernels.textdetect.ref import tile_profiles_torch

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
    images = torch.zeros((1, 64, 4096), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="tile"):
        tile_profiles(images, thresh=1.0, tile=(32, 2048))
    with pytest.raises(ValueError, match="tile"):
        phi_ops.edge_density(images, thresh=1.0, tile=(32, 2048))


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
    max_ops, max_depth = program_limits()
    leaves = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    too_long = (("leaf", 0),) + (("not",),) * max_ops
    too_deep = (("leaf", 0),) * (max_depth + 1) + (("and",),) * max_depth
    for prog in (too_long, too_deep, (("leaf", 2),), (("leaf", 0), ("and",)),
                 (("leaf", 0), ("leaf", 1)), (("leaf", 0), ("xor",))):
        with pytest.raises(ValueError, match="bitmap"):
            combine_bitmaps(leaves, prog)
    # the longest program it takes still runs
    longest = (("leaf", 0),) + (("not",),) * (max_ops - 1)
    assert torch.equal(combine_bitmaps(leaves, longest)[0],
                       combine_bitmaps_torch(leaves, longest)[0])


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
