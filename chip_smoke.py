#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. card   — print the card's name and power limit (nvidia-smi), build the
            CUDA kernels of ``src/repro_torch/csrc`` with nvcc for sm_90a
            (one nvcc per source, all seven started together).
2. kernels — hold each kernel against its plain PyTorch version on the card
            with ``torch.equal`` at the main path's shapes (CT, DX, US chunks,
            the bitmap combine of a 2^22-row scan and its ragged, K=1+1,
            K=8+1 and not-rooted variants, an over-long program refused,
            every selection value at one small shape; for the two detector
            kernels the unknown-device CT and DX chunks, a float32 stack, a
            (16, 64) tile and the float32 threshold straddle 2457.0001; for
            the jls kernel every selection value at the CT, DX and US stacks,
            a full-range uint16 stack and the edges H = 1, W = 1, W = 257,
            and its refusals), and time kernel, plain version and (where one
            exists) a single PyTorch call computing the same function, cold
            L2, CUDA events, median of 21. Then the staged scrub -> jls pair
            against the fused kernel at the CT chunk (equal; both timed).
3. pipeline — paths, each driven with the launch counts set to 0 just
            before it and read just after:
            the cold de-identification of a 256-slice CT, a DX and a US study
            (no detector; then US with recompress=False, the scrub kernel);
            and the detector path: registry_first on a 256-slice and a
            4-image unknown-device study (CT 320x512, DX 520x648), union on
            the CT, DX and US studies, then the post-scrub audit
            (``audit_dataset(device="cuda")``) of every raw and delivered
            instance of the two unknown-device studies.
            The kernel path must give payloads, compressed sizes, pixels,
            manifests, detection reports and detector counters equal to the
            port's host path (numpy oracle and codec); the first payload of
            each study must decode to its delivered pixels; the audit's flags
            must equal the CPU's, flag no delivered instance and at least one
            raw one; every kernel of a path must have launched. Prints the
            kernel path's span totals, MB/s for both paths (median of ROUNDS
            untraced runs each, in alternating order), the H2D / kernels /
            D2H / host-splice split of one CT chunk, and the detection
            upload beside the fused upload of one unknown-CT chunk.
            (f) the kernel-assisted encode: ``encode_batch`` (jls) and
            ``fused_encode_batch`` over the CT, DX and US stacks, byte-equal
            to the host ``codec.encode``; MB/s against the host loop.
            Then the serving paths:
            (d) a metadata catalog of 2^22 rows on the card
            (``StudyCatalog(device="cuda")``, 8192 accessions x 512
            instances): date ranges at ~1/10/50 % selectivity, which zone
            maps prune, and a full scan (In, Not, Contains); every card
            select must equal ``select(mode="oracle")``; prints both modes'
            select times (median of ROUNDS, alternating), rows scanned, and
            the host concat / H2D / compares + pack / kernel / D2H + unpack
            split of the full scan;
            (e) query-then-de-identify: ``DeidService.submit_query`` over a
            CT/DX/US/unknown-CT corpus, the broker, an autoscaled worker
            pool, a result lake, a journal and a hash-chained audit ledger;
            the kernel stack must equal a host stack (host codec and
            detector, catalog on the CPU) in selection, ticket, delivered
            outputs, manifests and ledger kind counts, both ledgers verify,
            and a replay of the query publishes nothing, launches bitmap
            once and fused never. Prints query -> drained seconds and MB/s
            of cold bytes for both stacks (fresh deployments, median of
            ROUNDS, alternating);
            (h) change-feed ingest on (e)'s two deployments: a ``PacsFeed``
            commits updates, a create and a delete, drained through
            ``ChangePooler`` -> broker -> ``IngestApplier`` with a pooler
            crash and a restart from the ``Checkpoint``; the resubmitted
            query sends exactly the new or changed selected accessions cold
            and the rest warm, equal to the host stack;
            (g) the operator launcher ``repro_torch.launch.deid_service`` at
            its defaults on the card, plain and ``--chaos``, equal to the
            same runs with ``--device cpu`` (all but the counted plain card
            run in child processes, the four runs at once).
4. result — one JSON line listing every kernel, then the device line.

Needs CUDA and the repository's ``src/`` beside this file; imports nothing of
the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12     # float32 outside the tensor cores (data sheet)
# int32 ALU rate: Hopper's SM has 64 INT32 lanes to 128 FP32 lanes, so half
# of the float32 peak
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
REPS = 21
ROUNDS = 3  # timed pipeline runs of each path per study
CT_SLICES = 256
MAIN_KERNELS = ("fused", "rice_prepass", "rice_len_rem", "scrub")
DETECTOR_KERNELS = ("textdetect", "phi_detect")
SERVE_KERNELS = ("bitmap", "fused", "rice_prepass", "rice_len_rem", "textdetect")
# path (d): a mid-size hospital archive's instance count, metadata only
CATALOG_ACCESSIONS = 8192
CATALOG_INSTANCES = 512          # per accession: 2^22 rows
CATALOG_BLOCK_ROWS = 512
SELECTIVITIES = (0.01, 0.10, 0.50)
STUDY_ID = "IRB-SERVE"

KERNELS = {
    "fused": ("src/repro_torch/csrc/fused.cu", "src/repro/kernels/fused/fused.py:117"),
    "rice_prepass": ("src/repro_torch/csrc/entropy.cu", "src/repro/kernels/jls/entropy.py:59"),
    "rice_len_rem": ("src/repro_torch/csrc/entropy.cu", "src/repro/kernels/jls/entropy.py:96"),
    "scrub": ("src/repro_torch/csrc/scrub.cu", "src/repro/kernels/scrub/scrub.py:65"),
    "textdetect": ("src/repro_torch/csrc/textdetect.cu",
                   "src/repro/kernels/textdetect/textdetect.py:67"),
    "phi_detect": ("src/repro_torch/csrc/phi_detect.cu",
                   "src/repro/kernels/phi_detect/phi_detect.py:45"),
    "bitmap": ("src/repro_torch/csrc/bitmap.cu", "src/repro/kernels/bitmap/bitmap.py:53"),
    "jls": ("src/repro_torch/csrc/jls.cu", "src/repro/kernels/jls/jls.py:75"),
}


_T0 = time.perf_counter()


def log(*a) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s]", *a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing
_FLUSH = None


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each with a cold
    L2 (a 256 MB buffer is rewritten between launches, outside the window)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: int, nops: int, ops_per_s: float = INT32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 2
def check_kernels(us_shape) -> dict:
    from repro_torch.dicom import codec
    from repro_torch.kernels.fused.ops import fused_scrub_residuals
    from repro_torch.kernels.fused.ref import fused_ref
    from repro_torch.kernels.jls import entropy
    from repro_torch.kernels.scrub.ops import pack_rects, scrub_images
    from repro_torch.kernels.scrub.ref import rect_mask, scrub_ref

    rng = np.random.default_rng(11)
    err = {name: 0 for name in MAIN_KERNELS}

    def compare(name, got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            diff = (got.long() - want.long()).abs().max().item() if got.shape == want.shape else -1
            raise AssertionError(f"{name} kernel != plain version on {what} (max |diff| {diff})")
        err[name] = max(err[name], int((got.long() - want.long()).abs().max().item()))

    def case(what, images_np, rect_lists, sv=1):
        images = torch.from_numpy(images_np).cuda()
        rects = torch.from_numpy(pack_rects(rect_lists)).cuda()
        bits = images_np.dtype.itemsize * 8
        res = fused_scrub_residuals(images, rects, sv=sv)
        compare("fused", res, fused_ref(images, rects, sv, bits), what)
        u, rs = entropy.rice_prepass(res)
        u_p, rs_p = entropy.rice_prepass_plain(res)
        compare("rice_prepass", u, u_p, what)
        compare("rice_prepass", rs, rs_p, what + " row sums")
        H, W = images_np.shape[1:]
        ks = [codec._rice_k_from_sum(int(r.sum(dtype=np.int64)), H * W) for r in rs.cpu().numpy()]
        ks_t = torch.tensor(ks, dtype=torch.int32, device="cuda")
        lens, rem = entropy.rice_len_rem(u, ks_t)
        lens_p, rem_p = entropy.rice_len_rem_plain(u, ks_t)
        compare("rice_len_rem", lens, lens_p, what)
        compare("rice_len_rem", rem, rem_p, what + " remainders")
        compare("scrub", scrub_images(images, rects), scrub_ref(images, rects), what)
        log(f"  equal: {what}")
        return images, rects, res, u, ks_t

    def full_range(shape, dtype):
        return rng.integers(0, np.iinfo(dtype).max + 1, size=shape, dtype=np.int64).astype(dtype)

    ct_rects = [(256, 0, 256, 22), (300, 22, 212, 80)]
    ct = (rng.normal(1200, 300, size=(32, 512, 512))).clip(0, 4095).astype(np.uint16)
    case("CT (32,512,512) u16, 0 rects", ct, [[] for _ in range(32)])
    ct_case = case("CT (32,512,512) u16, 2 rects", ct, [ct_rects] * 32)
    for H, W in ((2500, 2048), (2022, 2022)):
        dx_rects = [(0, 0, W, 40), (W - 560, 44, 560, 60)]
        case(f"DX (4,{H},{W}) u16 full range, 2 rects", full_range((4, H, W), np.uint16), [dx_rects] * 4)
    uH, uW = us_shape
    us_rects = [(0, 0, uW, 32), (uW - 200, 36, 200, 50), (0, uH - 20, uW, 20)]
    case(f"US (32,{uH},{uW}) u8, 3 rects", full_range((32, uH, uW), np.uint8), [us_rects] * 32)
    for dtype in (np.uint8, np.uint16):
        small = full_range((2, 70, 90), dtype)
        for sv in range(1, 8):
            case(f"sv={sv} (2,70,90) {np.dtype(dtype).name}", small,
                 [[(5, 5, 30, 20), (-3, -3, 10, 10)], [(40, 30, 200, 200)]], sv=sv)
    # k = 0 (a constant 2^15 plane has all-zero residuals) and Rice escapes
    # (a constant plane with full-range outliers: q > 23 at its small k)
    esc = np.full((2, 64, 96), 1 << 15, np.uint16)
    esc[1] = 100
    esc[1, 7, 9] = 65535
    esc[1, 40, 50] = 0
    case("k=0 and escapes (2,64,96) u16", esc, [[], []])
    log("kernels: every kernel equals its plain version on every case")

    # timing at the CT chunk shape of the main path (32,512,512) uint16, R=2
    images, rects, res, u, ks_t = ct_case
    N, H, W = images.shape
    npx, R = N * H * W, rects.shape[1]
    mask = rect_mask(rects, H, W)
    view16 = images.view(torch.int16)
    timed = {
        "fused": (lambda: fused_scrub_residuals(images, rects, sv=1),
                  lambda: fused_ref(images, rects, 1, 16), None,
                  npx * (2 + 4) + rects.numel() * 4, npx * (8 * R + 16)),
        "rice_prepass": (lambda: entropy.rice_prepass(res),
                         lambda: entropy.rice_prepass_plain(res), None,
                         npx * (4 + 4) + N * H * 4, npx * 5),
        "rice_len_rem": (lambda: entropy.rice_len_rem(u, ks_t),
                         lambda: entropy.rice_len_rem_plain(u, ks_t), None,
                         npx * (4 + 8) + N * 4, npx * 8),
        "scrub": (lambda: scrub_images(images, rects),
                  lambda: scrub_ref(images, rects),
                  lambda: view16.masked_fill(mask, 0),
                  npx * (2 + 2) + rects.numel() * 4, npx * (8 * R + 1)),
    }
    rows = {}
    for name, (kern, plain, library, nbytes, nops) in timed.items():
        b_ms, b_by = bound(nbytes, nops)
        rows[name] = {
            "ms": time_ms(kern),
            "plain_ms": time_ms(plain),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": time_ms(library) if library is not None else None,
            "max_abs_err": err[name],
            "shape": f"({N},{H},{W}) uint16, R={R}",
        }
        log(f"time {name}: {json.dumps(rows[name])}")
    return rows


def check_detector_kernels(us_shape) -> dict:
    """textdetect (all three outputs) and phi_detect against their plain
    versions, exact, at the detector path's chunk shapes; timed at the CT
    chunk."""
    from repro_torch.kernels.phi_detect.ops import DEFAULT_THRESH_FRAC, edge_density
    from repro_torch.kernels.phi_detect.ref import edge_density_ref
    from repro_torch.kernels.textdetect.ops import BINARIZE_FRAC, tile_profiles
    from repro_torch.kernels.textdetect.ref import tile_profiles_torch

    rng = np.random.default_rng(12)
    err = {name: 0.0 for name in DETECTOR_KERNELS}

    def compare(name, got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            diff = (got.double() - want.double()).abs().max().item() if got.shape == want.shape else -1
            raise AssertionError(f"{name} kernel != plain version on {what} (max |diff| {diff})")
        err[name] = max(err[name], (got.double() - want.double()).abs().max().item())

    def case(what, imgs_np, ceiling, tile=(32, 128), thresh=None):
        images = torch.from_numpy(imgs_np).cuda()
        t = ceiling * BINARIZE_FRAC if thresh is None else thresh
        for got, want in zip(tile_profiles(images, thresh=t, tile=tile),
                             tile_profiles_torch(images, t, tile)):
            compare("textdetect", got, want, what)
        et = ceiling * DEFAULT_THRESH_FRAC
        compare("phi_detect", edge_density(images, thresh=et, tile=tile),
                edge_density_ref(images, et, tile), what)
        log(f"  equal: {what}")
        return images

    def banners(shape, dtype, ceiling, full_range=False):
        """Anatomy, a glyph band of 1-px strokes, and a bright last column."""
        if full_range:
            imgs = rng.integers(0, int(ceiling) + 1, size=shape, dtype=np.int64)
        else:
            imgs = rng.normal(ceiling * 0.3, ceiling * 0.07, size=shape).clip(0, ceiling)
        imgs = imgs.astype(dtype)
        imgs[:, 8:30, 40::3] = ceiling
        imgs[:, :, -1] = ceiling
        return imgs

    ct = case("CT (32,512,512) u16", banners((32, 512, 512), np.uint16, 4095.0), 4095.0)
    case("CT tile (16,64) (32,512,512) u16", banners((32, 512, 512), np.uint16, 4095.0), 4095.0,
         tile=(16, 64))
    # a tile area that is not a power of two: the quotient must be IEEE
    case("CT tile (24,100) (32,512,512) u16", banners((32, 512, 512), np.uint16, 4095.0), 4095.0,
         tile=(24, 100))
    case("unknown CT (32,320,512) u16", banners((32, 320, 512), np.uint16, 4095.0), 4095.0)
    straddle = rng.integers(2450, 2465, size=(32, 320, 512)).astype(np.uint16)
    case("thresh 2457.0001 (32,320,512) u16", straddle, 4095.0, thresh=2457.0001)
    case("unknown DX (4,520,648) u16", banners((4, 520, 648), np.uint16, 4095.0), 4095.0)
    case("DX (4,2500,2048) u16 full range", banners((4, 2500, 2048), np.uint16, 65535.0, True),
         65535.0)
    uH, uW = us_shape
    case(f"US (32,{uH},{uW}) u8 full range", banners((32, uH, uW), np.uint8, 255.0, True), 255.0)
    case("float32 (8,512,512)", banners((8, 512, 512), np.float32, 1.0), 1.0)
    log("detector kernels: each equals its plain version on every case")

    # timing at the CT chunk of the main path, (32,512,512) uint16, (32,128)
    N, H, W = ct.shape
    th, tw = 32, 128
    npx, tiles = N * H * W, N * (H // th) * (W // tw)
    t, et = 4095.0 * BINARIZE_FRAC, 4095.0 * DEFAULT_THRESH_FRAC
    timed = {
        # compare, column count, row count, run add/multiply/max per pixel
        "textdetect": (lambda: tile_profiles(ct, thresh=t), lambda: tile_profiles_torch(ct, t, (th, tw)),
                       npx * 2 + tiles * (th + tw + 1) * 4, npx * 6, INT32_OPS_PER_S),
        # subtract, abs, compare, count per pixel
        "phi_detect": (lambda: edge_density(ct, thresh=et), lambda: edge_density_ref(ct, et, (th, tw)),
                       npx * 2 + tiles * 4, npx * 4, FP32_OPS_PER_S),
    }
    rows = {}
    for name, (kern, plain, nbytes, nops, rate) in timed.items():
        b_ms, b_by = bound(nbytes, nops, rate)
        rows[name] = {
            "ms": time_ms(kern),
            "plain_ms": time_ms(plain),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,  # no single PyTorch call computes either function
            "max_abs_err": err[name],
            "shape": f"({N},{H},{W}) uint16, tile ({th},{tw})",
        }
        log(f"time {name}: {json.dumps(rows[name])}")
    return rows


def check_bitmap_kernel() -> dict:
    """The bitmap combine against its plain version, exact (bitmap and
    count), at the 2^22-row full scan of path (d) and its variants; timed
    at the full scan (K = 4 leaves + validity)."""
    from repro_torch.kernels.bitmap.ops import (
        combine_bitmaps,
        combine_bitmaps_launch,
        combine_bitmaps_torch,
        pack_mask,
        program_limits,
    )

    rng = np.random.default_rng(13)
    n_full = CATALOG_ACCESSIONS * CATALOG_INSTANCES

    def leaves_of(n, k):
        masks = [rng.random(n) < rng.random() for _ in range(k)] + [rng.random(n) < 0.95]
        return torch.stack([pack_mask(torch.from_numpy(m).cuda()) for m in masks])

    def chain(k):
        """k leaves joined by and/or with a NOT on every other one, then the
        validity AND, as ``compile_query`` emits them."""
        prog = [("leaf", 0)]
        for i in range(1, k):
            prog += [("leaf", i)] + ([("not",)] if i % 2 else []) + [("and",) if i % 3 else ("or",)]
        return tuple(prog) + (("leaf", k), ("and",))

    def case(what, leaves, prog, want_count=None):
        got, count = combine_bitmaps(leaves, prog)
        want, plain_count = combine_bitmaps_torch(leaves, prog)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want) or count != int(plain_count):
            raise AssertionError(f"bitmap kernel != plain version on {what}")
        if want_count is not None and count != want_count:
            raise AssertionError(f"bitmap count {count} != {want_count} on {what}")
        log(f"  equal: {what}: {len(prog)} ops, count {count}")

    full = leaves_of(n_full, 4)
    case(f"W={full.shape[1]} (n=2^22), K=4+1", full, chain(4))
    case("ragged n=2^22-5, K=4+1", leaves_of(n_full - 5, 4), chain(4))
    case("n=2^22, K=1+1", leaves_of(n_full, 1), chain(1))
    case("n=2^22, K=8+1", leaves_of(n_full, 8), chain(8))
    n = n_full - 5
    empty_and_valid = torch.stack([pack_mask(torch.zeros(n, dtype=torch.bool, device="cuda")),
                                   pack_mask(torch.ones(n, dtype=torch.bool, device="cuda"))])
    case("not-rooted, n=2^22-5 (tail bits stay out)", empty_and_valid,
         (("leaf", 0), ("not",), ("leaf", 1), ("and",)), want_count=n)
    max_ops, max_depth = program_limits()
    try:
        combine_bitmaps(full, (("leaf", 0),) + (("not",),) * max_ops)
    except ValueError as e:
        log(f"  refused: a program of {max_ops + 1} ops (limit {max_ops}, depth {max_depth}): {e}")
    else:
        raise AssertionError("bitmap kernel took a program one op over its limit")
    log("bitmap kernel: equals its plain version on every case")

    prog = chain(4)
    K, W = full.shape
    # each leaf word read once, one word written; a bitwise op per program
    # op and a popcount per word (int32 ALU)
    b_ms, b_by = bound((K + 1) * W * 4, (len(prog) + 1) * W)
    row = {
        "ms": time_ms(lambda: combine_bitmaps_launch(full, prog)),
        "plain_ms": time_ms(lambda: combine_bitmaps_torch(full, prog)),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no single PyTorch call: torch has no popcount
        "max_abs_err": 0,
        "shape": f"({K},{W}) int32 words (n=2^22, 4 leaves + validity), {len(prog)} ops",
    }
    log(f"time bitmap: {json.dumps(row)}")
    return {"bitmap": row}


def check_jls_kernel(us_shape) -> dict:
    """Kernel 8, the JPEG-Lossless predictor, against its plain version
    (``torch.equal``) at the CT chunk and the DX and US stacks (every sv), a
    full-range uint16 stack, every sv at a small ragged shape in uint8 and
    uint16, and the edges H = 1, W = 1 and W = 257; the launch refusals.
    Timed at all three stacks (the CT chunk is its row); then the staged
    scrub -> jls pair against the fused kernel at the CT chunk with R = 2."""
    from repro_torch.kernels.fused.ops import fused_scrub_residuals
    from repro_torch.kernels.jls.ops import jls_residuals
    from repro_torch.kernels.jls.ref import residuals_ref
    from repro_torch.kernels.scrub.ops import pack_rects, scrub_images

    rng = np.random.default_rng(14)

    def full_range(shape, dtype):
        return rng.integers(0, np.iinfo(dtype).max + 1, size=shape, dtype=np.int64).astype(dtype)

    def case(what, images_np, svs):
        images = torch.from_numpy(images_np).cuda()
        bits = images_np.dtype.itemsize * 8
        for sv in svs:
            got, want = jls_residuals(images, sv=sv), residuals_ref(images, sv, bits)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"jls kernel != plain version on {what}, sv={sv}")
        log(f"  equal: {what}, sv {list(svs)}")
        return images

    every = range(1, 8)
    uH, uW = us_shape
    stacks = {
        "CT": case("CT (32,512,512) u16", rng.normal(1200, 300, size=(32, 512, 512))
                   .clip(0, 4095).astype(np.uint16), every),
        "DX": case("DX (4,2500,2048) u16 full range", full_range((4, 2500, 2048), np.uint16), every),
        "US": case(f"US (32,{uH},{uW}) u8 full range", full_range((32, uH, uW), np.uint8), every),
    }
    case("CT (32,512,512) u16 full range", full_range((32, 512, 512), np.uint16), (1, 4, 5, 6))
    for dtype in (np.uint8, np.uint16):
        name = np.dtype(dtype).name
        case(f"(2,70,90) {name}", full_range((2, 70, 90), dtype), every)
        for shape, edge in (((3, 1, 300), "H=1"), ((3, 70, 1), "W=1"), ((2, 9, 257), "W=257")):
            case(f"{edge} {shape} {name}", full_range(shape, dtype), every)
    for bad in ({"sv": 0}, {"sv": 8}, {"bits": 31}):
        try:
            jls_residuals(stacks["CT"], **bad)
        except ValueError as e:
            log(f"  refused: {bad}: {e}")
        else:
            raise AssertionError(f"jls kernel took {bad}")
    log("jls kernel: equals its plain version on every case")

    rows = {}
    for name, images in stacks.items():
        npx = images.numel()
        # one read of the plane, one int32 write; ~12 integer operations a
        # pixel (three neighbour loads' bounds, predictor, mask, wrap)
        b_ms, b_by = bound(npx * (images.element_size() + 4), npx * 12)
        rows[name] = {
            "ms": time_ms(lambda: jls_residuals(images, sv=1)),
            "plain_ms": time_ms(lambda: residuals_ref(images, 1, images.element_size() * 8)),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,  # no single PyTorch call computes the residuals
            "max_abs_err": 0,
            "shape": f"{tuple(images.shape)} {str(images.dtype).removeprefix('torch.')}, sv=1",
        }
        log(f"time jls {name}: {json.dumps(rows[name])}, "
            f"{100 * b_ms / rows[name]['ms']:.1f} % of the bound")

    # the staged pair (scrub, then jls) against the fused kernel: 10 against
    # 6 B/px in uint16
    ct = stacks["CT"]
    rects = torch.from_numpy(pack_rects([[(256, 0, 256, 22), (300, 22, 212, 80)]] * 32)).cuda()
    staged, fused = jls_residuals(scrub_images(ct, rects), sv=1), fused_scrub_residuals(ct, rects)
    torch.cuda.synchronize()
    if not torch.equal(staged, fused):
        raise AssertionError("staged scrub -> jls != fused kernel at the CT chunk")
    npx = ct.numel()
    pair = {}
    for name, fn, nbytes in (
            ("staged", lambda: jls_residuals(scrub_images(ct, rects), sv=1), npx * (4 + 6)),
            ("fused", lambda: fused_scrub_residuals(ct, rects, sv=1), npx * 6)):
        pair[name] = {"ms": time_ms(fn), "bound_ms": bound(nbytes + rects.numel() * 4, 0)[0],
                      "bytes_per_px": nbytes // npx}
    pair["staged_over_fused"] = pair["staged"]["ms"] / pair["fused"]["ms"]
    log(f"staged scrub -> jls vs fused at the CT chunk (32,512,512) u16, R=2: equal; "
        f"{json.dumps(pair)}")
    return {"jls": rows["CT"]}


# ---------------------------------------------------------------- phase 3
def chunk_split(study) -> dict:
    """H2D / kernels / D2H / host splice of one 32-slice CT chunk, driven
    through the same ops the executor calls."""
    from repro_torch.dicom import codec
    from repro_torch.kernels.fused.ops import fused_scrub_residuals
    from repro_torch.kernels.jls import entropy
    from repro_torch.kernels.scrub.ops import pack_rects

    ds = study.datasets[:32]
    H, W = ds[0].pixels.shape
    rects_np = pack_rects([study_rects(study)] * len(ds), R=4)
    host = torch.empty((len(ds), H, W), dtype=torch.uint16, pin_memory=True)
    host.numpy()[...] = np.stack([d.pixels for d in ds])
    rects_h = torch.from_numpy(rects_np).pin_memory()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    best = None
    for _ in range(5):
        torch.cuda.synchronize()
        ev[0].record()
        images = host.to("cuda", non_blocking=True)
        rects = rects_h.to("cuda", non_blocking=True)
        ev[1].record()
        res = fused_scrub_residuals(images, rects, sv=1)
        u, rs = entropy.rice_prepass(res)
        ev[2].record()
        rs_np = rs.cpu().numpy()
        ks = np.array([codec._rice_k_from_sum(int(r.sum(dtype=np.int64)), H * W) for r in rs_np],
                      np.int32)
        ev[3].record()
        lens, rem = entropy.rice_len_rem(u, ks)
        ev[4].record()
        u_np, lens_np, rem_np = u.cpu().numpy(), lens.cpu().numpy(), rem.cpu().numpy()
        ev[5].record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(len(ds)):
            codec.rice_pack(codec.rice_plan_from_prepass(
                u_np[j].reshape(-1), int(ks[j]), lens_np[j], rem_np[j]))
        splice = (time.perf_counter() - t0) * 1e3
        split = {
            "h2d_ms": ev[0].elapsed_time(ev[1]),
            "fused_prepass_ms": ev[1].elapsed_time(ev[2]),
            "rs_sync_and_k_ms": ev[2].elapsed_time(ev[3]),
            "len_rem_ms": ev[3].elapsed_time(ev[4]),
            "d2h_u_lens_rem_ms": ev[4].elapsed_time(ev[5]),
            "host_splice_serial_ms": splice,
        }
        if best is None or sum(split.values()) < sum(best.values()):
            best = split
    return best


def study_rects(study):
    from repro_torch.core import scripts
    from repro_torch.core.rules import parse_scrub_script

    d = study.device
    return list(parse_scrub_script(scripts.DEFAULT_SCRUB_SCRIPT).get(
        (d.modality, d.make, d.model, d.rows, d.cols)) or ())


def detect_split(study) -> dict:
    """The detection pass of one 32-slice unknown-CT chunk beside the fused
    pass's upload of the same planes: both upload the chunk (the executor
    does the same, detection first and synchronously)."""
    from repro_torch.detect import DetectorPolicy, policy_thresh
    from repro_torch.kernels.fused.ops import fused_scrub_residuals
    from repro_torch.kernels.scrub.ops import pack_rects
    from repro_torch.kernels.textdetect.ops import row_hits

    ds = study.datasets[:32]
    H, W = ds[0].pixels.shape
    thresh = policy_thresh(ds[0], DetectorPolicy())
    host = torch.empty((len(ds), H, W), dtype=torch.uint16, pin_memory=True)
    host.numpy()[...] = np.stack([d.pixels for d in ds])
    rects_h = torch.from_numpy(pack_rects([[(0, 0, W, 24)]] * len(ds), R=4)).pin_memory()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    best = None
    for _ in range(5):
        torch.cuda.synchronize()
        ev[0].record()
        images = host.to("cuda", non_blocking=True)
        ev[1].record()
        hits = row_hits(images, thresh=thresh)
        ev[2].record()
        hits.cpu()
        ev[3].record()
        images = host.to("cuda", non_blocking=True)
        rects = rects_h.to("cuda", non_blocking=True)
        ev[4].record()
        fused_scrub_residuals(images, rects, sv=1)
        ev[5].record()
        torch.cuda.synchronize()
        split = {
            "detect_h2d_ms": ev[0].elapsed_time(ev[1]),
            "textdetect_and_row_sum_ms": ev[1].elapsed_time(ev[2]),
            "row_hits_d2h_ms": ev[2].elapsed_time(ev[3]),
            "fused_h2d_ms": ev[3].elapsed_time(ev[4]),
            "fused_ms": ev[4].elapsed_time(ev[5]),
        }
        if best is None or sum(split.values()) < sum(best.values()):
            best = split
    return best


class _WallClock:
    def now(self) -> float:
        return time.perf_counter()


def make_pipeline(path: str, rc: bool = True, mode=None, tracer=None):
    """A ``DeidPipeline`` on the card: the kernel path, or the host path
    (numpy detector oracle and codec)."""
    from repro_torch.core import DeidPipeline
    from repro_torch.detect import DetectorPolicy

    policy = None if mode is None else DetectorPolicy(mode=mode)
    pipe = DeidPipeline(device="cuda", recompress=rc, detector_policy=policy, tracer=tracer)
    if path == "host":
        pipe.executor.use_kernel = False
    return pipe


def drive(pipe, study, pseudo):
    """One ``run_study``: its result, the executor's outputs, the detection
    reports, the detector counters and the wall seconds."""
    from repro_torch.core import build_request
    from repro_torch.detect.report import DetectStats

    captured, reports = [], []
    run, scrub_study = pipe.executor.run, pipe.scrub.scrub_study

    def capture(items, **kw):
        outs = run(items, **kw)
        captured.extend(outs)
        return outs

    def capture_reports(datasets, executor):
        slots = scrub_study(datasets, executor)
        reports.extend(None if r is None or r.detection is None else dataclasses.asdict(r.detection)
                       for r, _ in slots)
        return slots

    pipe.executor.run, pipe.scrub.scrub_study = capture, capture_reports
    req = build_request(pseudo, study.accession, study.mrn)
    t0 = time.perf_counter()
    result = pipe.run_study(study, req, "w0")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pipe.executor.close()
    stats = {f: getattr(pipe.scrub.detect_stats, f) for f in DetectStats._FIELDS}
    return result, captured, reports, stats, secs


def job_label(job) -> str:
    s, rc, mode = job
    return (f"{s.modality} x{len(s.datasets)} {s.datasets[0].pixels.shape} {s.device.id()} "
            f"recompress={rc} detector={mode or 'none'}")


def check_equal(job, k_run, h_run, tracer) -> None:
    """The kernel path's run of ``job`` against the host path's, exact."""
    from repro_torch.dicom import codec

    s, rc, mode = job
    label = job_label(job)
    k_res, k_outs, k_rep, k_stats, _ = k_run
    h_res, h_outs, h_rep, h_stats, _ = h_run
    assert k_res.manifest.to_json() == h_res.manifest.to_json(), label
    assert len(k_outs) == len(h_outs) == len(s.datasets), label
    for a, b in zip(k_outs, h_outs):
        assert a.payload == b.payload, label
        assert np.array_equal(a.pixels, b.pixels), label
    if rc:
        # the decoder is a slow host oracle (a sequential parse once a
        # stream holds Rice escapes, minutes for a 512x512 plane): the
        # first instance of each study, which carries the blanked text
        assert np.array_equal(codec.decode(k_outs[0].payload), k_outs[0].pixels), label
    for a, b in zip(k_res.delivered, h_res.delivered):
        assert a.elements == b.elements and np.array_equal(a.pixels, b.pixels), label
    if rc:
        assert all(e.compressed_bytes > 0 for e in k_res.manifest.entries), label
    assert k_rep == h_rep and k_stats == h_stats, label
    if mode is not None:
        assert k_stats["detector_runs"] == len(s.datasets) and k_stats["detected"] > 0, label
    spans = {name: sum(sp.duration for sp in tracer.spans(name))
             for name in ("pipeline.run_study", "kernel.detect_dispatch", "kernel.dispatch",
                          "kernel.entropy_code")}
    log(f"pipeline {label}: payloads, pixels, manifest, detection reports and counters equal "
        f"{json.dumps(k_stats)}; kernel path spans (s) {json.dumps(spans)}")


def run_path(name, jobs, pseudo, kernels, during=None):
    """Drive ``jobs`` on the kernel path with every launch count set to 0
    just before and read just after (``during`` runs inside that window on
    the kernel runs), then on the host path, and hold the two equal.
    Returns the launch counts and what ``during`` returned."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs.trace import Tracer

    tracers = [Tracer(_WallClock()) for _ in jobs]
    reset_launches()
    kernel_runs = [drive(make_pipeline("kernel", rc, mode, tr), s, pseudo)
                   for (s, rc, mode), tr in zip(jobs, tracers)]
    extra = during(kernel_runs) if during is not None else None
    launches = dict(LAUNCHES)
    log(f"{name} path launches: {json.dumps(launches)}")
    for k in kernels:
        assert launches[k] > 0, f"kernel {k} never launched on the {name} path"
    host_runs = [drive(make_pipeline("host", rc, mode), s, pseudo) for s, rc, mode in jobs]
    for job, k_run, h_run, tr in zip(jobs, kernel_runs, host_runs, tracers):
        check_equal(job, k_run, h_run, tr)
    return launches, extra


def throughput(jobs, pseudo) -> None:
    """MB/s of both paths, tracing off: ROUNDS runs each per job, the order
    of the two paths alternating from round to round."""
    secs = {(j, path): [] for j in range(len(jobs)) for path in ("kernel", "host")}
    for r in range(ROUNDS):
        for j, (s, rc, mode) in enumerate(jobs):
            for path in (("kernel", "host") if r % 2 == 0 else ("host", "kernel")):
                secs[(j, path)].append(drive(make_pipeline(path, rc, mode), s, pseudo)[-1])
    for j, job in enumerate(jobs):
        mb = sum(d.pixels.nbytes for d in job[0].datasets) / 1e6
        rates = {path: sorted(mb / t for t in secs[(j, path)]) for path in ("kernel", "host")}
        log(f"throughput {job_label(job)}: {mb:.1f} MB; MB/s median kernel path "
            f"{statistics.median(rates['kernel'])} host path {statistics.median(rates['host'])}; "
            f"all runs {json.dumps(rates)}")


def audit(studies_and_runs, device) -> dict:
    """``audit_dataset`` flags of every raw and every delivered instance."""
    from repro_torch.kernels.phi_detect.ops import audit_dataset

    return {
        label: ([audit_dataset(d, device=device) for d in s.datasets],
                [audit_dataset(d, device=device) for d in run[0].delivered])
        for label, s, run in studies_and_runs
    }


def run_detector_path(jobs, n_audited, pseudo) -> dict:
    """The detector path; its first ``n_audited`` jobs are audited."""
    from repro_torch.kernels.phi_detect.ops import audit_dataset

    # warm-up outside the counted window: kernel loads
    drive(make_pipeline("kernel", True, "registry_first"), jobs[1][0], pseudo)
    audit_dataset(jobs[1][0].datasets[0], device="cuda")
    audited = {}

    def audit_on_card(kernel_runs):
        audited["runs"] = [(job_label(job), job[0], run)
                           for job, run in zip(jobs[:n_audited], kernel_runs)]
        return audit(audited["runs"], "cuda")

    # detection runs before the scrub, whose recompressing chunks go through
    # the cold path's kernels as well
    launches, card_flags = run_path("detector", jobs, pseudo,
                                    DETECTOR_KERNELS + ("fused", "rice_prepass", "rice_len_rem"),
                                    during=audit_on_card)
    cpu_flags = audit(audited["runs"], "cpu")
    for label, (raw, delivered) in card_flags.items():
        assert (raw, delivered) == cpu_flags[label], f"audit on the card != CPU: {label}"
        assert not any(delivered), f"a delivered instance failed the audit: {label}"
        assert any(raw), f"no raw instance flagged (negative control): {label}"
        log(f"audit {label}: raw flagged {sum(raw)}/{len(raw)}, delivered flagged "
            f"{sum(delivered)}/{len(delivered)}; equal to the CPU")
    return launches


def run_encode_path(studies) -> dict:
    """Path (f), the kernel-assisted encode: ``encode_batch`` (jls kernel)
    and ``fused_encode_batch`` (fused kernel, the study's PHI rects) over
    each study's stack in 32-plane chunks, in a counted window; every
    payload byte-equal to the host ``codec.encode`` of its plane (blanked,
    for the fused encode). Then MB/s of ``encode_batch`` against the host
    ``codec.encode`` loop, ROUNDS alternating runs. Returns the launches."""
    from repro_torch.core.scrub import numpy_blank
    from repro_torch.dicom import codec
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.fused.ops import fused_encode_batch
    from repro_torch.kernels.jls.ops import encode_batch

    stacks = [(s, np.stack([d.pixels for d in s.datasets]), study_rects(s)) for s in studies]

    def kernel_encode(planes):
        return [b for c0 in range(0, len(planes), 32) for b in encode_batch(planes[c0:c0 + 32])]

    def kernel_fused(planes, rects):
        return [b for c0 in range(0, len(planes), 32)
                for b in fused_encode_batch(planes[c0:c0 + 32], [rects] * len(planes[c0:c0 + 32]))]

    def host_encode(planes):
        return [codec.encode(p, 1) for p in planes]

    kernel_encode(stacks[-1][1][:1])  # warm-up outside the window: kernel loads
    kernel_fused(stacks[-1][1][:1], stacks[-1][2])
    reset_launches()
    k_out = [(kernel_encode(planes), kernel_fused(planes, rects)) for _, planes, rects in stacks]
    launches = dict(LAUNCHES)
    log(f"encode path launches: {json.dumps(launches)}")
    for k in ("jls", "fused"):
        assert launches[k] > 0, f"kernel {k} never launched on the encode path"
    for (s, planes, rects), (k_enc, k_fused) in zip(stacks, k_out):
        assert k_enc == host_encode(planes), f"encode_batch != codec.encode: {s.accession}"
        blanked = [numpy_blank(p, rects) for p in planes]
        assert k_fused == host_encode(blanked), f"fused_encode_batch != codec.encode: {s.accession}"
        # the decoder is a slow host oracle (20 s a DX plane here): the first
        # payload of each encode of the CT and US stacks; phase 3's main path
        # decodes a blanked DX plane
        if s.modality != "DX":
            assert np.array_equal(codec.decode(k_enc[0]), planes[0]), s.accession
            assert np.array_equal(codec.decode(k_fused[0]), blanked[0]), s.accession
        log(f"encode {s.accession} {planes.shape} {planes.dtype}, {len(rects)} rects: "
            f"{len(k_enc)} encode_batch and {len(k_fused)} fused_encode_batch payloads equal to "
            f"codec.encode; {sum(map(len, k_enc)) / planes.nbytes:.4f} of the pixel bytes")
    secs = {(s.accession, path): [] for s, _, _ in stacks for path in ("kernel", "host")}
    for r in range(ROUNDS):
        for s, planes, _ in stacks:
            for path in (("kernel", "host") if r % 2 == 0 else ("host", "kernel")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (kernel_encode if path == "kernel" else host_encode)(planes)
                secs[(s.accession, path)].append(time.perf_counter() - t0)
    for s, planes, _ in stacks:
        mb = planes.nbytes / 1e6
        rates = {p: sorted(mb / t for t in secs[(s.accession, p)]) for p in ("kernel", "host")}
        log(f"encode throughput {s.accession} {planes.shape}: {mb:.1f} MB; MB/s median "
            f"encode_batch {statistics.median(rates['kernel'])} host codec.encode "
            f"{statistics.median(rates['host'])}; all runs {json.dumps(rates)}")
    return launches


# path (g): each launcher run but the counted card run goes to a child
# process, all started together (a run's host time is mostly the at-rest XOR
# of its archive, one core each). A child zeroes the launch counts, runs the
# launcher and prints one JSON line: its returned dict, wall seconds and
# the counts.
_LAUNCHER_CHILD = """
import contextlib, io, json, sys, time
sys.path.insert(0, "src")
import torch
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch.deid_service import main
argv = json.loads(sys.argv[1])
reset_launches()
t0 = time.perf_counter()
with contextlib.redirect_stdout(io.StringIO()):
    out = main(argv)
if "--device" not in argv:
    torch.cuda.synchronize()
print(json.dumps({"result": out, "wall_s": time.perf_counter() - t0, "launches": dict(LAUNCHES)}))
"""
LAUNCHER_FIELDS = ("studies", "instances", "minutes", "cost_usd", "crashes", "health", "bytes",
                   "throughput")
LAUNCHER_KERNELS = ("fused", "rice_prepass", "rice_len_rem")
LAUNCHER_MODES = {"plain": (), "chaos": ("--chaos",)}


def run_launcher_path() -> dict:
    """Path (g), the operator launcher ``repro_torch.launch.deid_service``
    at its defaults (30 studies x 3 images, seed 0), on the card plain and
    ``--chaos`` and the same arguments with ``--device cpu``, each with a
    fresh journal. The plain card run goes in this process, in a counted
    window; the other three run in child processes started just before it.
    The card runs must equal the CPU runs in every field: they are one
    package, so the archive sizes (``bytes``, ``throughput``) must match
    too. Returns the launches of the plain card run."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.deid_service import main as launcher

    root = Path(__file__).resolve().parent
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-launch-") as tmp:
        def argv(where, mode):
            device = ("--device", "cpu") if where == "cpu" else ()
            return ["--journal", str(Path(tmp) / f"{where}-{mode}.jsonl"), *device,
                    *LAUNCHER_MODES[mode]]

        children = {
            (where, mode): subprocess.Popen(
                [sys.executable, "-c", _LAUNCHER_CHILD, json.dumps(argv(where, mode))],
                cwd=root, stdout=subprocess.PIPE, text=True)
            for where, mode in (("card", "chaos"), ("cpu", "plain"), ("cpu", "chaos"))
        }
        try:
            reset_launches()
            t0 = time.perf_counter()
            out = launcher(argv("card", "plain"))
            torch.cuda.synchronize()
            runs[("card", "plain")] = {"result": out, "wall_s": time.perf_counter() - t0,
                                       "launches": dict(LAUNCHES)}
            for key, child in children.items():
                stdout, _ = child.communicate(timeout=900)
                if child.returncode != 0:
                    raise RuntimeError(f"launcher run {key} failed (rc {child.returncode})")
                runs[key] = json.loads(stdout.strip().splitlines()[-1])
        finally:
            for child in children.values():
                if child.poll() is None:
                    child.kill()
                    child.wait()
    for mode in LAUNCHER_MODES:
        card, cpu = runs[("card", mode)], runs[("cpu", mode)]
        for f in LAUNCHER_FIELDS:
            # a child's dict went through JSON: compare in that form
            assert json.loads(json.dumps(card["result"][f])) == cpu["result"][f], (mode, f)
        assert (card["result"]["crashes"] > 0) == (mode == "chaos"), card["result"]["crashes"]
        for k in LAUNCHER_KERNELS:
            assert card["launches"][k] > 0, f"kernel {k} never launched on the launcher path ({mode})"
        mb = card["result"]["bytes"] / 1e6
        log(f"launcher (g) {mode}: card equal to --device cpu in {', '.join(LAUNCHER_FIELDS)}; "
            f"{card['result']['studies']} studies, {card['result']['instances']}, "
            f"{mb:.1f} MB archive; wall s card {card['wall_s']} cpu {cpu['wall_s']} "
            f"(the four runs overlap); MB/s card {mb / card['wall_s']} "
            f"cpu {mb / cpu['wall_s']}; sim minutes {card['result']['minutes']}, "
            f"cost ${card['result']['cost_usd']}, health {json.dumps(card['result']['health'])}; "
            f"launches {json.dumps(card['launches'])}")
    return runs[("card", "plain")]["launches"]


# ------------------------------------------------- phase 3: serving paths
_MODALITIES = ["CT", "MR", "DX", "US", "CR", "PT"]
_MAKES = ["GE Medical", "Siemens", "Philips", "Canon"]
_MODELS = ["Optima CT660", "MAGNETOM Aera", "Epiq 7", "DRX-1"]
_PARTS = ["CHEST", "HEAD", "ABDOMEN", "KNEE"]


def build_scan_catalog():
    """Path (d)'s catalog: metadata rows as ``benchmarks/catalogbench.py``
    builds them (StudyDate sorted, so sealed blocks carry tight zone maps),
    drawn in bulk and ingested one accession at a time."""
    from repro_torch.catalog import StudyCatalog

    rng = np.random.default_rng(2718)
    n = CATALOG_ACCESSIONS * CATALOG_INSTANCES
    dates = np.sort(20150000 + rng.integers(1, 6, n) * 10000 + rng.integers(1, 13, n) * 100
                    + rng.integers(1, 29, n))
    cols = {
        "modality": [_MODALITIES[i] for i in rng.integers(len(_MODALITIES), size=n).tolist()],
        "body_part": [_PARTS[i] for i in rng.integers(len(_PARTS), size=n).tolist()],
        "manufacturer": [_MAKES[i] for i in rng.integers(len(_MAKES), size=n).tolist()],
        "model": [_MODELS[i] for i in rng.integers(len(_MODELS), size=n).tolist()],
        "study_date": dates.tolist(),
        "bits_stored": rng.choice([8, 12, 16], size=n).tolist(),
        "rows": [512] * n,
        "cols": [512] * n,
        "nbytes": rng.integers(10_000, 600_000, size=n).tolist(),
        "burned_in": (rng.random(n) < 0.1).astype(int).tolist(),
        "burned_in_detected": (rng.random(n) < 0.08).astype(int).tolist(),
    }
    names = list(cols)
    cat = StudyCatalog(block_rows=CATALOG_BLOCK_ROWS, device="cuda")
    t0 = time.perf_counter()
    for a in range(CATALOG_ACCESSIONS):
        lo, hi = a * CATALOG_INSTANCES, (a + 1) * CATALOG_INSTANCES
        rows = [dict(zip(names, vals)) for vals in zip(*(cols[c][lo:hi] for c in names))]
        cat.ingest_rows(f"SC{a:05d}", rows, etag=str(a))
    return cat, dates, time.perf_counter() - t0


def select_split(cat, pred) -> dict:
    """One unpruned select through the steps ``eval_vectorized`` takes:
    host concat of the scanned columns, their upload, the leaf compares and
    packing, the bitmap kernel, and the copy back with the unpack."""
    from repro_torch.catalog.query import _leaf_mask_torch, compile_query, eval_oracle
    from repro_torch.kernels.bitmap.ops import combine_bitmaps_launch, pack_mask, unpack_mask

    compiled = compile_query(pred, cat.dicts)
    blocks = cat._all_blocks()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    best = None
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrays = {c: np.concatenate([b.cols[c] for b in blocks]) for c in compiled.cols}
        valid = np.concatenate([b.valid for b in blocks])
        concat = (time.perf_counter() - t0) * 1e3
        ev[0].record()
        tarrays = {c: torch.from_numpy(a).to("cuda") for c, a in arrays.items()}
        tvalid = torch.from_numpy(valid).to("cuda")
        ev[1].record()
        leaves = torch.stack([pack_mask(_leaf_mask_torch(leaf, tarrays))
                              for leaf in compiled.leaves] + [pack_mask(tvalid)])
        ev[2].record()
        bitmap, _ = combine_bitmaps_launch(leaves, compiled.program)
        ev[3].record()
        ev[3].synchronize()
        t1 = time.perf_counter()
        mask = unpack_mask(bitmap, valid.shape[0])
        unpack = (time.perf_counter() - t1) * 1e3
        split = {
            "host_concat_ms": concat,
            "columns_h2d_ms": ev[0].elapsed_time(ev[1]),
            "compares_and_pack_ms": ev[1].elapsed_time(ev[2]),
            "bitmap_kernel_ms": ev[2].elapsed_time(ev[3]),
            "d2h_and_unpack_ms": unpack,
        }
        if best is None or sum(split.values()) < sum(best.values()):
            best = split
    if not np.array_equal(mask, eval_oracle(compiled, arrays, valid)):
        raise AssertionError("split select != oracle scan")
    best["rows"] = int(valid.shape[0])
    best["columns_uploaded_mb"] = sum(a.nbytes for a in arrays.values()) / 1e6 + valid.nbytes / 1e6
    return best


def run_catalog_path() -> int:
    """Path (d). Returns the bitmap launches of its counted window."""
    from repro_torch.catalog import And, Contains, In, Not, Range
    from repro_torch.kernels import LAUNCHES, reset_launches

    cat, dates, ingest_s = build_scan_catalog()
    n = len(dates)
    log(f"catalog (d): {n} rows, {CATALOG_ACCESSIONS} accessions, {len(cat._blocks)} blocks of "
        f"{CATALOG_BLOCK_ROWS}, ingest {ingest_s:.1f} s")
    queries = {f"date range {f:.0%}": Range("study_date", int(dates[0]), int(dates[int(f * n) - 1]))
               for f in SELECTIVITIES}
    full = And(In("modality", ["CT", "MR", "DX"]), Not(Contains("model", "epiq")))
    queries["full scan In/Not/Contains"] = full
    cat.select(full)  # warm-up outside the counted window: kernel load
    reset_launches()
    selections = {}
    for name, q in queries.items():
        before = cat.stats.rows_scanned
        selections[name] = (cat.select(q), cat.stats.rows_scanned - before)
    launches = LAUNCHES["bitmap"]
    log(f"catalog path launches: {json.dumps(dict(LAUNCHES))}")
    assert launches == len(queries), f"bitmap launched {launches} times for {len(queries)} selects"
    for name, q in queries.items():
        sel, scanned = selections[name]
        want = cat.select(q, mode="oracle")
        if sel != want:
            raise AssertionError(f"catalog select on the card != oracle: {name}")
        assert sel.total_instances > 0, name
        log(f"select {name}: equal to the oracle; {sel.total_instances} rows matched "
            f"({sel.total_instances / n:.4f}), {len(sel.accessions)} accessions, rows scanned "
            f"{scanned}, blocks scanned {sel.blocks_scanned} pruned {sel.blocks_pruned}")
    assert selections["full scan In/Not/Contains"][0].blocks_pruned == 0
    secs = {(name, mode): [] for name in queries for mode in ("auto", "oracle")}
    for r in range(ROUNDS):
        for name, q in queries.items():
            for mode in (("auto", "oracle") if r % 2 == 0 else ("oracle", "auto")):
                t0 = time.perf_counter()
                cat.select(q, mode=mode)
                secs[(name, mode)].append(time.perf_counter() - t0)
    for name in queries:
        log(f"select time {name}: median s card {statistics.median(secs[(name, 'auto')])} "
            f"oracle {statistics.median(secs[(name, 'oracle')])}; all "
            f"{json.dumps({m: secs[(name, m)] for m in ('auto', 'oracle')})}")
    log(f"full-scan select split: {json.dumps(select_split(cat, full))}")
    return launches


def serve_corpus(gen, us_device):
    """Path (e)'s corpus at the registry's shapes."""
    from repro_torch.dicom.devices import DeviceKey

    studies = []
    for i in range(4):
        studies.append(gen.gen_study(f"SERVE-CT{i}", n_images=64,
                                     device=DeviceKey("CT", "GE", "Discovery", 512, 512)))
    for i in range(2):
        studies.append(gen.gen_study(f"SERVE-DX{i}", n_images=2,
                                     device=DeviceKey("DX", "GE", "Definium", 2500, 2048)))
    for i in range(4):
        studies.append(gen.gen_study(f"SERVE-US{i}", n_images=16, device=us_device))
    for i in range(2):
        studies.append(gen.gen_study(f"SERVE-UCT{i}", n_images=32,
                                     device=gen.unknown_device(f"serve{i}", "CT")))
    return studies


def serve_query(studies):
    """CT and DX in a StudyDate window holding an unknown-device CT and
    some, not all, of the CT and DX studies."""
    from repro_torch.catalog import And, In, Range

    eligible = sorted((s.study_date, s.accession) for s in studies if s.modality in ("CT", "DX"))
    unknown = next(i for i, (_, acc) in enumerate(eligible) if "UCT" in acc)
    lo = max(0, min(unknown, len(eligible) - 5))
    window = eligible[lo:lo + 5]
    want = [acc for d, acc in eligible if window[0][0] <= d <= window[-1][0]]
    assert any("UCT" in a for a in want) and len(want) < len(eligible), want
    return And(In("modality", ["CT", "DX"]), Range("study_date", int(window[0][0]),
                                                   int(window[-1][0]))), sorted(want)


def make_source(studies, device):
    from repro_torch.catalog import StudyCatalog
    from repro_torch.storage.object_store import StudyStore

    source = StudyStore("lake")
    for s in studies:
        source.put_study(s.accession, s)
    source.attach_catalog(StudyCatalog(device=device))
    return source


def deploy(path, source, tmp):
    """A fresh serving deployment over ``source``: broker, journal, result
    lake, audit ledger, pipeline on the card (the kernel path, or the host
    codec and detector) and an autoscaled worker pool."""
    from repro_torch.audit import AuditLedger
    from repro_torch.core import DeidPipeline
    from repro_torch.detect import DetectorPolicy
    from repro_torch.lake import ResultLake
    from repro_torch.queueing import Autoscaler, AutoscalerConfig, Broker, DeidWorker, Journal
    from repro_torch.queueing import WorkerPool
    from repro_torch.queueing.server import DeidService
    from repro_torch.storage.object_store import StudyStore
    from repro_torch.utils.timing import SimClock

    clock = SimClock()
    root = Path(tempfile.mkdtemp(prefix=f"{path}-", dir=tmp))
    ledger = AuditLedger(root / "audit.jsonl", clock=clock)
    broker = Broker(clock, visibility_timeout=300.0)
    journal = Journal(root / "journal.jsonl")
    lake = ResultLake(max_bytes=16 << 30, ledger=ledger)
    pipe = DeidPipeline(device="cuda", detector_policy=DetectorPolicy(mode="registry_first"),
                        lake=lake, ledger=ledger)
    if path == "host":
        pipe.executor.use_kernel = False
    service = DeidService(broker, source, journal, result_lake=lake, pipeline=pipe,
                          catalog=source.catalog, ledger=ledger)
    service.register_study(STUDY_ID, key=b"s" * 32)
    dest = StudyStore("researcher")
    pool = WorkerPool(broker, Autoscaler(broker, AutoscalerConfig(), clock),
                      lambda wid: DeidWorker(wid, pipe, source, dest, journal, ledger=ledger))
    return types.SimpleNamespace(clock=clock, root=root, source=source, ledger=ledger,
                                 broker=broker, journal=journal, lake=lake, pipeline=pipe,
                                 service=service, dest=dest, pool=pool)


def serve(dep, query, mrns):
    """submit_query, drain, resolve: (selection, ticket, wall seconds)."""
    t0 = time.perf_counter()
    sel, ticket = dep.service.submit_query(STUDY_ID, query, mrns)
    dep.pool.drain()
    dep.service.planner.resolve()
    torch.cuda.synchronize()
    return sel, ticket, time.perf_counter() - t0


def close(dep):
    dep.pipeline.executor.close()
    dep.journal.close()
    dep.ledger.close()


def check_served(k_dep, k_run, h_dep, h_run, want):
    """The kernel stack's query-then-de-identify against the host stack's."""
    k_sel, k_ticket, _ = k_run
    h_sel, h_ticket, _ = h_run
    assert list(k_sel.accessions) == want, (k_sel.accessions, want)
    assert k_sel == h_sel, "selection differs between the kernel and host stacks"
    for t in (k_ticket, h_ticket):
        assert t.done() and not t.failed and sorted(t.cold) == want, (t.cold, t.failed)
    for f in ("hits", "coalesced", "cold", "rejected", "failed"):
        assert getattr(k_ticket, f) == getattr(h_ticket, f), f
    pseudo = k_dep.service._studies[STUDY_ID]
    n_out = 0
    for acc in want:
        rid = f"{STUDY_ID}/{pseudo.accession(acc)}"
        k_out, h_out = list(k_dep.dest.outputs(rid)), list(h_dep.dest.outputs(rid))
        assert len(k_out) == len(h_out) > 0, acc
        for a, b in zip(k_out, h_out):
            assert a.elements == b.elements and a.encapsulated == b.encapsulated, acc
            assert np.array_equal(a.pixels, b.pixels), acc
        n_out += len(k_out)
    assert (k_dep.journal.merged_manifest(STUDY_ID).to_json()
            == h_dep.journal.merged_manifest(STUDY_ID).to_json())
    assert k_dep.ledger.kind_counts() == h_dep.ledger.kind_counts()
    assert k_dep.ledger.verify() == [] and h_dep.ledger.verify() == []
    log(f"served (e): {len(want)} accessions, {k_sel.total_instances} instances, {n_out} delivered; "
        f"outputs, manifests, selection and ledger kind counts equal to the host stack "
        f"{json.dumps(k_dep.ledger.kind_counts())}; both ledgers verify")


def run_serving_path(gen, us_device) -> dict:
    """Path (e), then path (h) on its deployments. Returns the launches of
    each one's counted window."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    studies = serve_corpus(gen, us_device)
    for s in studies:
        log(f"serving study {s.accession}: {len(s.datasets)}x{s.datasets[0].pixels.shape} "
            f"{s.device.id()} {s.study_date}")
    query, want = serve_query(studies)
    mrns = {s.accession: s.mrn for s in studies}
    sources = {"kernel": make_source(studies, "cuda"), "host": make_source(studies, "cpu")}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        warm = deploy("kernel", sources["kernel"], tmp)  # outside the window: kernel loads
        serve(warm, query, mrns)
        close(warm)
        k_dep = deploy("kernel", sources["kernel"], tmp)
        reset_launches()
        k_run = serve(k_dep, query, mrns)
        launches = dict(LAUNCHES)
        log(f"serving path launches: {json.dumps(launches)}")
        for k in SERVE_KERNELS:
            assert launches[k] > 0, f"kernel {k} never launched on the serving path"
        h_dep = deploy("host", sources["host"], tmp)
        h_run = serve(h_dep, query, mrns)
        check_served(k_dep, k_run, h_dep, h_run, want)
        # the replay is served warm from the result lake
        published = k_dep.broker.total_published
        reset_launches()
        sel2, replay = k_dep.service.submit_query(STUDY_ID, query, mrns)
        replayed = dict(LAUNCHES)
        assert k_dep.broker.total_published == published, "the replay published work"
        assert sorted(replay.hits) == want and not replay.cold and not replay.coalesced
        assert replayed["bitmap"] == 1 and replayed["fused"] == 0, replayed
        assert sel2 == k_run[0]
        log(f"replay: all {len(replay.hits)} accessions warm, 0 publishes, launches "
            f"{json.dumps(replayed)}")
        secs = {"kernel": [], "host": []}
        for r in range(ROUNDS):
            for path in (("kernel", "host") if r % 2 == 0 else ("host", "kernel")):
                dep = deploy(path, sources[path], tmp)
                secs[path].append(serve(dep, query, mrns)[2])
                close(dep)
        mb = k_run[0].total_bytes / 1e6
        log(f"query -> drained (e): {mb:.1f} MB cold; median s kernel stack "
            f"{statistics.median(secs['kernel'])} host stack {statistics.median(secs['host'])}; "
            f"MB/s kernel {mb / statistics.median(secs['kernel'])} host "
            f"{mb / statistics.median(secs['host'])}; all runs {json.dumps(secs)}")
        # path (h): the change feed mutates the corpus under both deployments
        ingest_launches = run_ingest_path(k_dep, h_dep, studies, query, mrns)
        for dep in (k_dep, h_dep):
            close(dep)
    return {"serving": launches, "ingest": ingest_launches}


# path (h): the change feed's seed, and the kernels its counted window needs.
# Under this seed one selected CT's re-acquisition keeps a StudyDate inside
# the query's window and another's leaves it, so the resubmit meets both a
# changed selected study and one that drops out of the selection.
FEED_SEED = 1
INGEST_KERNELS = ("bitmap", "fused", "rice_prepass", "rice_len_rem")


def plan_mutations(studies, query, selected):
    """Path (h)'s commits, in order: updates of 2 selected CT accessions, 1
    create the query selects, 1 delete of another selected accession. A
    re-acquired study gets a new StudyDate, so an update may leave the
    window: one update that stays and one that leaves are taken where the
    selection has them. The create is chosen to land in the window, which
    keeps the expected cold set non-empty. Dates come from a probe feed of
    the same seed (one image a study: the date does not depend on the
    count)."""
    from repro_torch.ingest import PacsFeed

    lo, hi = query.preds[1].lo, query.preds[1].hi

    def v1_in_window(acc):
        probe = PacsFeed(FEED_SEED, modality="CT", images_per_study=1)
        probe.commit("create", acc)
        return lo <= int(probe.fetch(acc)[0].study_date) <= hi

    ct = [s.accession for s in studies if s.accession in selected and s.modality == "CT"]
    stays = [a for a in ct if v1_in_window(a)]
    leaves = [a for a in ct if a not in stays]
    updates = (stays[:1] + leaves[:1]) if stays and leaves else (stays + leaves)[:2]
    create = next(a for a in (f"SERVE-NEW{i}" for i in range(1000)) if v1_in_window(a))
    delete = next(a for a in selected if a not in updates)
    assert len(updates) == 2, ct
    return [("update", updates[0]), ("update", updates[1]), ("create", create),
            ("delete", delete)]


def drain_feed(dep, studies, plan):
    """Commit ``plan`` to a fresh ``PacsFeed`` that adopted the corpus and
    drain it through ``ChangePooler`` -> broker -> ``IngestApplier`` into the
    deployment's source store, with one ``PoolerCrash`` mid-batch and a
    restart from the durable ``Checkpoint``."""
    from repro_torch.ingest import ChangePooler, Checkpoint, IngestApplier, PacsFeed, PoolerCrash
    from repro_torch.queueing import Broker

    feed = PacsFeed(FEED_SEED, modality="CT", images_per_study=64)
    for s in studies:
        feed.adopt(s.accession, s)
    for op, acc in plan:
        feed.commit(op, acc)
    broker = Broker(dep.clock, visibility_timeout=60.0)
    path = dep.root / "ingest.ckpt"

    def process(ckpt):
        return (ChangePooler(feed, broker, ckpt, dep.clock, seed=FEED_SEED, batch=3),
                IngestApplier(broker, feed, dep.source, ckpt, ledger=dep.ledger))

    pooler, applier = process(Checkpoint(path))
    applied, crashes = [], 0
    t0 = time.perf_counter()
    for poll in range(100):
        if not pooler.behind() and broker.empty():
            break
        try:
            pooler.poll_once(crash_after=1 if poll == 0 else None)
        except PoolerCrash:
            crashes += 1
            pooler.checkpoint.close()
            pooler, applier = process(Checkpoint(path))
        applied += applier.drain()
        dep.clock.advance(30.0)
    secs = time.perf_counter() - t0
    assert not pooler.behind() and broker.empty() and crashes == 1
    ckpt = pooler.checkpoint
    ckpt.close()
    return types.SimpleNamespace(
        feed=feed, applied=[(op.seq, op.op, op.accession, op.etag, op.rows) for op in applied],
        outcomes=list(Checkpoint(path).outcome_log), secs=secs,
        stats=(pooler.stats.as_dict(), applier.stats.as_dict()))


def run_ingest_path(k_dep, h_dep, studies, query, mrns) -> dict:
    """Path (h): change-feed ingest into path (e)'s deployments, then
    incremental re-de-identification. Both deployments have served the
    query; the feed commits updates, a create and a delete; the resubmitted
    query must send exactly the selected accessions that are new or whose
    source etag changed cold (amplification 1.0), serve every other one
    warm, and deliver nothing of the deleted one. The kernel stack runs in a
    counted window and must equal the host stack in applied ops, checkpoint
    outcomes, selection, ticket and ledger kind counts."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    first = k_dep.source.catalog.select(query)
    plan = plan_mutations(studies, query, list(first.accessions))
    log(f"ingest (h) first selection {list(first.accessions)}; plan {plan}")
    before = {a: k_dep.source.study_etag(a) for a in first.accessions}
    # the kernel deployment also served (e)'s replay: compare what (h) adds
    kinds_before = {name: dep.ledger.kind_counts() for name, dep in (("kernel", k_dep),
                                                                    ("host", h_dep))}
    results = {}
    for name, dep in (("kernel", k_dep), ("host", h_dep)):
        if name == "kernel":
            reset_launches()
        drained = drain_feed(dep, studies, plan)
        mrns2 = dict(mrns)
        for _, acc in plan:
            fetched = drained.feed.fetch(acc)
            if fetched is not None:
                mrns2[acc] = fetched[0].mrn
        sel, ticket, secs = serve(dep, query, mrns2)
        if name == "kernel":
            launches = dict(LAUNCHES)
        results[name] = (drained, sel, ticket, secs)
    log(f"ingest path launches: {json.dumps(launches)}")
    for k in INGEST_KERNELS:
        assert launches[k] > 0, f"kernel {k} never launched on the ingest path"
    (k_dr, k_sel, k_ticket, k_secs), (h_dr, h_sel, h_ticket, h_secs) = (
        results["kernel"], results["host"])
    deleted = plan[-1][1]
    expected = sorted(a for a in k_sel.accessions
                      if a not in before or k_dep.source.study_etag(a) != before[a])
    assert expected, "the mutations left nothing of the selection to re-de-identify"
    assert k_sel == k_dep.source.catalog.select(query, mode="oracle"), "card select != oracle"
    assert deleted not in k_sel.accessions and deleted not in k_ticket.outputs
    assert not k_ticket.failed and k_ticket.done()
    assert sorted(k_ticket.cold) == expected, (k_ticket.cold, expected)
    assert sorted(k_ticket.hits) == sorted(set(k_sel.accessions) - set(expected))
    assert not k_ticket.coalesced
    assert k_dr.applied == h_dr.applied and k_dr.outcomes == h_dr.outcomes
    assert k_dr.stats == h_dr.stats
    assert k_sel == h_sel, "selection differs between the kernel and host stacks"
    for f in ("hits", "coalesced", "cold", "rejected", "failed"):
        assert getattr(k_ticket, f) == getattr(h_ticket, f), f
    added = {name: {k: n - kinds_before[name].get(k, 0) for k, n in dep.ledger.kind_counts().items()
                    if n != kinds_before[name].get(k, 0)}
             for name, dep in (("kernel", k_dep), ("host", h_dep))}
    assert added["kernel"] == added["host"], added
    refreshed = {name: (dep.service.planner.stats.stale_refreshes, dep.journal.supersessions)
                 for name, dep in (("kernel", k_dep), ("host", h_dep))}
    assert refreshed["kernel"] == refreshed["host"], refreshed
    assert added["kernel"]["ingest_apply"] == len(k_dr.outcomes)  # one record an outcome
    assert k_dep.ledger.verify() == [] and h_dep.ledger.verify() == []
    events = k_dr.feed.last_seq
    log(f"ingest (h): {events} feed events, applied {[(s, op, a) for s, op, a, _, _ in k_dr.applied]}, "
        f"outcomes {[o['outcome'] for o in k_dr.outcomes]}, pooler/applier {json.dumps(k_dr.stats)}; "
        f"resubmit selects {list(k_sel.accessions)}: cold {sorted(k_ticket.cold)} (expected "
        f"{expected}, amplification {len(k_ticket.cold) / len(expected)}), warm "
        f"{sorted(k_ticket.hits)}, {deleted} deleted and not delivered; equal to the host stack; "
        f"ledger records added {json.dumps(added['kernel'])}; planner stale refreshes and journal "
        f"supersessions {refreshed['kernel']}")
    log(f"ingest (h) drain: events/s kernel stack {events / k_dr.secs} host stack "
        f"{events / h_dr.secs}; resubmit query -> drained s kernel stack {k_secs} host stack "
        f"{h_secs}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs only on a card")
    from repro_torch.core import PseudonymService, TrustMode
    from repro_torch.dicom.devices import DeviceKey
    from repro_torch.dicom.generator import StudyGenerator
    from repro_torch.kernels.build import build_all

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    report = build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(report)} sources")
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")

    gen = StudyGenerator(seed=7)
    ct = gen.gen_study("SMOKE-CT", device=DeviceKey("CT", "GE", "Discovery", 512, 512),
                       n_images=CT_SLICES)
    dx = gen.gen_study("SMOKE-DX", device=DeviceKey("DX", "GE", "Definium", 2500, 2048),
                       n_images=4)
    us = gen.gen_study("SMOKE-US", modality="US", n_images=32)
    # unknown devices: no scrub rule, so registry_first scans every instance
    uct = gen.gen_study("SMOKE-UCT", device=gen.unknown_device("smoke", "CT"), n_images=CT_SLICES)
    udx = gen.gen_study("SMOKE-UDX", device=gen.unknown_device("smoke", "DX"), n_images=4)
    for s in (ct, dx, us, uct, udx):
        log(f"study {s.accession}: {len(s.datasets)}x{s.datasets[0].pixels.shape} "
            f"{s.datasets[0].pixels.dtype} {s.device.id()}, {len(s.phi_rects)} with burned-in text")

    rows = check_kernels(us.datasets[0].pixels.shape)
    rows.update(check_detector_kernels(us.datasets[0].pixels.shape))
    rows.update(check_bitmap_kernel())
    rows.update(check_jls_kernel(us.datasets[0].pixels.shape))
    pseudo = PseudonymService("IRB-SMOKE", TrustMode.POST_IRB, key=b"s" * 32)

    # the cold de-identification path (no detector); warm-up outside the
    # counted window: CUDA context, kernel loads
    main_jobs = [(ct, True, None), (dx, True, None), (us, True, None), (us, False, None)]
    drive(make_pipeline("kernel"), us, pseudo)
    launches, _ = run_path("main", main_jobs, pseudo, MAIN_KERNELS)
    throughput(main_jobs, pseudo)
    split = chunk_split(ct)
    log(f"CT chunk (32,512,512) split: {json.dumps(split)}")

    # the detector path: registry_first on the unknown devices (audited),
    # union on the known ones
    det_jobs = [(uct, True, "registry_first"), (udx, True, "registry_first"),
                (ct, True, "union"), (dx, True, "union"), (us, True, "union")]
    launches.update({k: v for k, v in run_detector_path(det_jobs, 2, pseudo).items()
                     if k in DETECTOR_KERNELS})
    throughput([det_jobs[0], det_jobs[2]], pseudo)
    log(f"unknown-CT chunk (32,320,512) detection beside fused upload: "
        f"{json.dumps(detect_split(uct))}")

    # the kernel-assisted encode (f): the jls and fused kernels under the
    # host Golomb-Rice coder
    launches["jls"] = run_encode_path([ct, dx, us])["jls"]

    # the serving paths: the catalog at 2^22 rows (d), then query-then-
    # de-identify through the broker and the worker pool (e), then change-
    # feed ingest and incremental re-de-identification on (e)'s deployments
    catalog_launches = run_catalog_path()
    served = run_serving_path(gen, us.device)
    launches["bitmap"] = served["serving"]["bitmap"]
    log(f"bitmap launches: catalog path (d) {catalog_launches}, serving path (e) "
        f"{launches['bitmap']}, ingest path (h) {served['ingest']['bitmap']}")

    # the operator launcher (g) at its defaults
    run_launcher_path()

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "equal": True, **row,
                        "pct_of_bound": 100 * row["bound_ms"] / row["ms"]})
    log(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
