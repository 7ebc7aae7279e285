#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. card   — print the card's name and power limit (nvidia-smi), build the
            CUDA kernels of ``src/repro_torch/csrc`` with nvcc for sm_90a
            (one nvcc per source, all eight started together).
2. kernels — hold each kernel against its plain PyTorch version on the card
            with ``torch.equal`` at the main path's shapes (CT, DX, US chunks,
            the bitmap combine of a 2^22-row scan and its ragged, K=1+1,
            K=8+1 and not-rooted variants, programs of 65, 1000 and 5000 ops
            and a 40-deep nesting, which the wrapper schedules into launches,
            every selection value at one small shape; for the two detector
            kernels the unknown-device CT and DX chunks, a float32 stack, a
            (16, 64) tile and the float32 threshold straddle 2457.0001; for
            the jls kernel every selection value at the CT, DX and US stacks,
            a full-range uint16 stack and the edges H = 1, W = 1, W = 257,
            and its refusals; for scrub, fused, jls, phi_detect and
            textdetect the layouts their 16-byte chunks meet, from
            ``kernels/*/cases.py``;
            and inputs past the launch limits of earlier versions: 65536
            images, 65536 rows, 65537 tile rows, tile (32, 2048), 5000 rects
            in scrub and fused, a plane of 2^31 + 32768 pixels), and time
            kernel, plain version and (where one exists) a single PyTorch
            call computing the same function, cold L2, CUDA events around the
            call, median of 21; scrub, phi_detect and jls also where the
            paths launch them (the US chunk with recompression off; the
            audit's one-image CT and DX launches; the CT, DX and US chunks of
            the encode) and scrub, phi_detect and bitmap at one block or word
            (the floor of a time taken this way). Then the
            staged scrub -> jls pair against the fused kernel at the CT chunk
            (equal; both timed). The decode-attention kernel, which replaces
            no TPU kernel, against its plain version at the serve cells'
            decode shapes, timed beside its bound, the plain version, SDPA
            and a plain read of the same rows (``check_decode_attn``).
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
            run in child processes, the four runs at once);
            (i) the paper's Figure 2b suite: every ``tests/features`` file
            through ``run_feature(device="cuda")``, every scenario passing,
            equal to ``device="cpu"``, each instance blanked by scrub;
            (j) the fleet simulator: ``FleetSim`` on the card under traffic
            (bursty cohorts and a query mix) and every chaos kind, 24
            studies x 2 images with recompression, unknown devices and the
            change feed, then 8 x 2 with recompression off, each beside the
            same run with ``device="cpu"`` in a child process; every default
            checker green, the event-log and audit digests, metrics, bucket
            and lake equal to the CPU run's, and the trace too with the
            executor spans' path labels read as the host path's; prints
            wall seconds and the share of ``run_study`` in the executor;
            (k) the scrub farm: ``ScrubFarm()`` over every card on a
            CT/DX/US batch (``process_datasets``) and
            ``ElasticFarmController`` over four pool entries naming
            ``cuda:0``, each equal to ``numpy_blank``;
            (l) LM serving, plain PyTorch (no kernel of the port; the launch
            counts must not move): qwen2-0.5b at its full width and depth in
            bf16 on the card (``build_model`` from generator seed 0), 8
            requests of 64-512 prompt tokens, 32 greedy new tokens each,
            through ``ServeEngine``; prints prefill ms, decode ms a step,
            tokens/s and peak memory beside their bounds and the card line,
            and traces the prefill and one decode step, replayed through its
            CUDA graph and run eagerly; the same architecture in f32 built on the CPU and copied to the
            card, prefill + 4 decode steps of 2 x 64 tokens (logits within
            1e-3, greedy tokens equal); every family reduced, card against
            CPU (dense, sliding window, two MoE, SSM, hybrid served, greedy
            tokens equal; the VLM and the encoder prefilled, logits within
            1e-4); falcon-mamba served at B == P.
            (m) LM training, plain PyTorch: (m1) ``python -m
            repro_torch.launch.train --arch qwen2-0.5b --full`` on the card,
            B 8 x S 1024, bf16 with an f32 master copy, remat "full", lr 3e-4
            cosine with 5 warm-up steps, 2 warm-up steps (the second traced
            with ``torch.profiler``) and 10 timed between synchronizes: step
            ms, tokens/s, peak memory, the FLOP bound, the final checkpoint
            save; every loss finite, the last below the first, the AdamW
            state 12 bytes a parameter; (m2) the same architecture in f32 cut
            to 4 layers, 2 steps of B 2 x S 128 on the card and on the CPU
            from the same weights (loss and gnorm within 1e-4 relative, every
            weight's f32 master within 1e-4 relative per leaf; the
            zero-initialised QKV biases, which hold only AdamW's normalised
            steps, within 2 x the summed learning rate); (m3) every family reduced, 3 steps card against CPU
            (losses within 1e-4), 2 microbatches against 1 (1e-5), the
            launcher with ``--compression``; (m4) a checkpoint saved at step 2
            on the card restores bit for bit into a fresh state and 2 more
            steps equal the uninterrupted run; (m5)
            ``examples/deid_to_training_torch.py`` on the card: scrub and
            phi_detect launched (counts read around it), delivered pixels,
            audit and 20 losses equal to its ``--device cpu`` run. (m1)-(m4)
            launch none of the port's kernels.
            (n) LM serving on a mesh, plain PyTorch on DTensors: one NCCL
            rank a card, spawned by the script; (n1) qwen2-0.5b at full width
            in bf16 on (data 1, model every card), each rank drawing its own
            weight shards from seed 0 (``place_model``), (l)'s 8 requests
            through ``ServeEngine``; prints prefill ms, decode ms a step,
            tokens/s, each card's peak and one decode step's collectives
            (none may all-gather a parameter); the f32 model against the same
            weights gathered unsharded on cuda:0 (logits within 1e-3, greedy
            tokens equal). With four cards or more, on (data 1, model 4):
            (n2) qwen1.5-110b at full width cut to 2 layers in f32 against
            its weights gathered on rank 0; (n3) qwen1.5-110b at full width
            and depth in bf16 (55.6 GB of weights a card), timed as (n1)
            beside its bounds. With fewer it says so and shrinks nothing.
            (o) the multi-pod dry-run (``repro_torch.launch.dryrun``), in
            child processes, each on a fake world (meta tensors on a cuda
            mesh; nothing allocated): (o1) (m1)'s own step on a world of 1,
            its traced peak within 10 % of (m1)'s ``max_memory_allocated``
            and its FLOPs beside (m1)'s FLOP bound's; (o2) (l)'s decode step
            at a cache of P + 32, its peak beside (l)'s and its bytes beside
            those of (l)'s decode bound; (o3) with four cards, (n3)'s decode
            step on (data 1, model 4) on a fake world of 4, its collectives
            equal to (n3)'s ``CollectiveLog`` in kind, count and bytes;
            (o4) ``python -m repro_torch.launch.dryrun`` on four production
            cells (16x16 or 2x16x16 fake worlds), each ``ok``, the train
            cells' FLOPs over every device within (0.5, 3.0) x 6 N D. No
            kernel of the port launches.
            (l), (m), (n) and (o) run after phase 4's timings, last before
            the result lines.
4. result — fused and textdetect timed at every shape their wrappers
            counted on the cold and the detector path, and at one block, and
            bitmap at each shape it was counted at on path (e);
            launches x (ms - bound) of every kernel (for scrub, fused, jls,
            phi_detect, textdetect and bitmap at each shape they were
            launched at on the counted paths, with the launches counted there
            by shape), one JSON line listing every kernel, then the device
            line.

Needs CUDA and the repository's ``src/`` beside this file; imports nothing of
the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from collections import Counter
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.launch import hw  # noqa: E402  (the H100 SXM's data-sheet figures)

HBM_BYTES_PER_S = hw.HBM_BW        # device memory rate
FP32_OPS_PER_S = hw.PEAK_FLOPS_F32  # float32 outside the tensor cores
# int32 ALU rate: Hopper's SM has 64 INT32 lanes to 128 FP32 lanes, so half
# of the float32 peak
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
REPS = 21
WARM = 200  # 256 MB rewrites before each timing, ~20 ms of the card's time
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
    L2 (a 256 MB buffer is rewritten between launches, outside the window).
    The buffer is first rewritten ``WARM`` times, so that no time is taken
    while the card comes out of the idle spells of the host-side checks."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(WARM):
        _FLUSH.zero_()
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


def bucket(n: int) -> int:
    """The executor's power-of-two rect bucket for n rects."""
    return 1 << max(n - 1, 0).bit_length()


def scrub_ops(N: int, H: int, W: int, R: int) -> int:
    """The scrub function's least operation count: for each row, 8 integer
    operations that turn each rect into that row's x-interval, and one
    select for each pixel."""
    return N * H * R * 8 + N * H * W


def launched_row(what, key, fn, nbytes, nops, rate=INT32_OPS_PER_S, library=None) -> dict:
    """A kernel timed at a shape the paths launch it at. ``key`` is that
    launch's shape, dtype and detail as its wrapper counts them in
    ``LAUNCH_SHAPES``: main fills in the launches counted there."""
    b_ms, b_by = bound(nbytes, nops, rate)
    row = {"shape": what, "key": key, "ms": time_ms(fn), "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": time_ms(library) if library is not None else None}
    row["pct_of_bound"] = 100 * b_ms / row["ms"]
    log(f"  time at {what}: {json.dumps(row)}")
    return row


def check_scrub_edges() -> int:
    """The scrub kernel against its plain version, exact, at every layout of
    ``kernels/scrub/cases.py`` (where its 16-byte chunks meet the data).
    Returns the case count."""
    from repro_torch.kernels.scrub import cases
    from repro_torch.kernels.scrub.ops import pack_rects, scrub_images
    from repro_torch.kernels.scrub.ref import scrub_ref

    rng = np.random.default_rng(15)
    n = 0
    for dtype in cases.DTYPES:
        for N, H, W in cases.SHAPES:
            base = torch.from_numpy(cases.planes(rng, dtype, (N, H, W))).cuda()
            for off in cases.OFFSETS:
                images = base[off:off + N]
                view = cases.SAME_WIDTH_INT[images.element_size()]
                for label, make in cases.RECT_SETS.items():
                    rects = torch.from_numpy(pack_rects([make(H, W)] * N)).cuda()
                    got, want = scrub_images(images, rects), scrub_ref(images, rects)
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(view), want.view(view)):
                        raise AssertionError(f"scrub kernel != plain version on {np.dtype(dtype).name} "
                                             f"{(N, H, W)} offset {off}, {label}")
                    n += 1
        log(f"  equal: scrub edge cases, {np.dtype(dtype).name}")
    return n


def check_fused_edges() -> int:
    """The fused kernel against its plain version, exact, at every layout
    of ``kernels/fused/cases.py`` (where its strips of 16-byte chunks meet
    the data), every selection value. Returns the case count."""
    from repro_torch.kernels.fused import cases
    from repro_torch.kernels.fused.ops import fused_scrub_residuals
    from repro_torch.kernels.fused.ref import fused_ref
    from repro_torch.kernels.scrub.ops import pack_rects

    rng = np.random.default_rng(17)
    n = 0
    for dtype in cases.DTYPES:
        for N, H, W in cases.SHAPES:
            base = torch.from_numpy(cases.planes(rng, dtype, (N, H, W))).cuda()
            rects = torch.from_numpy(pack_rects(cases.rect_lists(N, H, W))).cuda()
            for off in cases.OFFSETS:
                images = base[off:off + N]
                for sv in cases.SVS:
                    got = fused_scrub_residuals(images, rects, sv=sv)
                    want = fused_ref(images, rects, sv, images.element_size() * 8)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"fused kernel != plain version on {np.dtype(dtype).name} "
                                             f"{(N, H, W)} offset {off}, sv {sv}")
                    n += 1
        log(f"  equal: fused edge cases, {np.dtype(dtype).name}")
    return n


def check_launch_limits() -> None:
    """Inputs past the launch limits the C entry points once refused, each
    equal to its plain version: 65536 images (scrub, fused, jls, both Rice
    passes, textdetect, phi_detect), 65536 rows (fused, jls) and 65537 tile
    rows (textdetect, phi_detect), tile (32, 2048) (textdetect, phi_detect),
    5000 rects (scrub; fused on its 16-byte and pixel paths) and a plane of
    2^31 + 32768 pixels (scrub)."""
    from repro_torch.kernels.fused.ops import fused_scrub_residuals
    from repro_torch.kernels.fused.ref import fused_ref
    from repro_torch.kernels.jls import entropy
    from repro_torch.kernels.jls.ops import jls_residuals
    from repro_torch.kernels.jls.ref import residuals_ref
    from repro_torch.kernels.phi_detect.ops import edge_density
    from repro_torch.kernels.phi_detect.ref import edge_density_ref
    from repro_torch.kernels.scrub.ops import pack_rects, scrub_images
    from repro_torch.kernels.scrub.ref import scrub_ref
    from repro_torch.kernels.textdetect.ops import tile_profiles
    from repro_torch.kernels.textdetect.ref import tile_profiles_torch

    rng = np.random.default_rng(18)

    def equal(what, got, want):
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"kernel != plain version past the old launch limits: {what}")
        log(f"  equal past the old limits: {what}")

    for shape in ((65536, 2, 9), (2, 65536, 9)):
        for dtype in (np.uint8, np.uint16):
            name = f"{shape} {np.dtype(dtype).name}"
            images = torch.from_numpy(rng.integers(0, np.iinfo(dtype).max + 1, size=shape)
                                      .astype(dtype)).cuda()
            bits = images.element_size() * 8
            rects = torch.from_numpy(pack_rects([[(1, 0, 2, 1)]] * shape[0])).cuda()
            res = fused_scrub_residuals(images, rects, sv=4)
            equal(f"fused {name}", res, fused_ref(images, rects, 4, bits))
            equal(f"jls {name}", jls_residuals(images, sv=5), residuals_ref(images, 5, bits))
            if shape[0] == 65536:
                equal(f"rice_prepass {name}", entropy.rice_prepass(res), entropy.rice_prepass_plain(res))
                u = entropy.rice_prepass(res)[0]
                ks = torch.from_numpy(rng.integers(0, 31, size=shape[0]).astype(np.int32)).cuda()
                equal(f"rice_len_rem {name}", entropy.rice_len_rem(u, ks),
                      entropy.rice_len_rem_plain(u, ks))
    scrub_in = torch.randint(1, 256, (65536, 1, 3), dtype=torch.uint8, device="cuda")
    scrub_r = torch.from_numpy(pack_rects([[(1, 0, 1, 1)], []] * 32768)).cuda()
    equal("scrub (65536, 1, 3) uint8", scrub_images(scrub_in, scrub_r), scrub_ref(scrub_in, scrub_r))
    many = torch.from_numpy(rng.integers(0, 65536, size=(2, 70, 301)).astype(np.uint16)).cuda()
    many_r = torch.from_numpy(pack_rects([[(int(x), int(y), int(w), 1) for x, y, w in zip(
        rng.integers(-5, 301, 5000), rng.integers(-5, 70, 5000), rng.integers(1, 9, 5000))]] * 2)).cuda()
    equal("scrub 5000 rects", scrub_images(many, many_r), scrub_ref(many, many_r))
    for dtype in (np.uint8, np.uint16):
        for W in (304, 301):  # the 16-byte path, the pixel path
            images = torch.from_numpy(rng.integers(0, np.iinfo(dtype).max + 1, size=(2, 70, W))
                                      .astype(dtype)).cuda()
            rects = torch.from_numpy(pack_rects([[(int(x), int(y), int(w), 2) for x, y, w in zip(
                rng.integers(-5, W, 5000), rng.integers(-5, 70, 5000),
                rng.integers(1, 9, 5000))]] * 2)).cuda()
            equal(f"fused 5000 rects (2, 70, {W}) {np.dtype(dtype).name}",
                  fused_scrub_residuals(images, rects, sv=7),
                  fused_ref(images, rects, 7, images.element_size() * 8))
    H, W = 32768, 65537  # 2^31 + 32768 pixels
    plane = torch.randint(1, 256, (1, H, W), dtype=torch.uint8, device="cuda")
    plane_r = torch.tensor([[[5, 0, 3, H], [0, H - 2, W, 2], [W - 1, 30000, 1, 10]]],
                           dtype=torch.int32, device="cuda")
    equal(f"scrub (1, {H}, {W}) uint8", scrub_images(plane, plane_r), scrub_ref(plane, plane_r))
    del plane
    wide = torch.zeros((2, 64, 4100), dtype=torch.uint8, device="cuda")
    wide[:, 3, :] = 255
    wide[:, 9, 100:3000:3] = 255
    wide[1, 40, 1000:2100] = 255
    for shape, tile, images in (((2, 64, 4100), (32, 2048), wide),
                                ((65536, 1, 8), (1, 8), None), ((1, 65537, 8), (1, 8), None)):
        if images is None:
            images = torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.uint8)).cuda()
        equal(f"textdetect {shape} tile {tile}", tile_profiles(images, thresh=100.0, tile=tile),
              tile_profiles_torch(images, 100.0, tile))
        equal(f"phi_detect {shape} tile {tile}", edge_density(images, thresh=100.0, tile=tile),
              edge_density_ref(images, 100.0, tile))


def check_phi_edges() -> int:
    """phi_detect against its plain version, exact, at every layout of
    ``kernels/phi_detect/cases.py`` (where its 16-byte chunks and shuffles
    meet the data). Returns the case count."""
    from repro_torch.kernels.phi_detect import cases
    from repro_torch.kernels.phi_detect.ops import edge_density
    from repro_torch.kernels.phi_detect.ref import edge_density_ref

    rng = np.random.default_rng(16)
    n = 0
    for dtype in cases.DTYPES:
        for N, H, W in cases.SHAPES:
            base = torch.from_numpy(cases.planes(rng, dtype, (N, H, W))).cuda()
            for off in cases.OFFSETS:
                images = base[off:off + N]
                for tile in cases.TILES:
                    for thresh in cases.threshes(dtype):
                        got, want = (edge_density(images, thresh=thresh, tile=tile),
                                     edge_density_ref(images, thresh, tile))
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"phi_detect kernel != plain version on {np.dtype(dtype).name} "
                                f"{(N, H, W)} offset {off}, tile {tile}, thresh {thresh}")
                        n += 1
        log(f"  equal: phi_detect edge cases, {np.dtype(dtype).name}")
    return n


def check_text_edges() -> int:
    """textdetect against its plain version, exact (rows, columns, runs), at
    every layout of ``kernels/textdetect/cases.py`` (where its 16-byte
    chunks, 32-pixel words and row joins meet the data). Returns the case
    count."""
    from repro_torch.kernels.textdetect import cases
    from repro_torch.kernels.textdetect.ops import tile_profiles
    from repro_torch.kernels.textdetect.ref import tile_profiles_torch

    rng = np.random.default_rng(19)
    n = 0
    for dtype in cases.DTYPES:
        for shape in cases.SHAPES:
            N = shape[0]
            base = torch.from_numpy(cases.planes(rng, dtype, shape)).cuda()
            for off in cases.OFFSETS:
                images = base[off:off + N]
                for tile in cases.TILES:
                    for thresh in cases.threshes(dtype, shape):
                        got = tile_profiles(images, thresh=thresh, tile=tile)
                        want = tile_profiles_torch(images, thresh, tile)
                        torch.cuda.synchronize()
                        if not all(torch.equal(a, b) for a, b in zip(got, want)):
                            raise AssertionError(
                                f"textdetect kernel != plain version on {np.dtype(dtype).name} "
                                f"{shape} offset {off}, tile {tile}, thresh {thresh}")
                        n += 1
        log(f"  equal: textdetect edge cases, {np.dtype(dtype).name}")
    return n


# ---------------------------------------------------------------- phase 2
def check_kernels(us_shape, us_rects) -> dict:
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
    log(f"scrub: {check_scrub_edges()} edge cases equal to the plain version")
    log(f"fused: {check_fused_edges()} edge cases equal to the plain version")
    check_launch_limits()

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
                  npx * (2 + 2) + rects.numel() * 4, scrub_ops(N, H, W, R)),
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
    # the same bytes moved by a device-to-device copy: what scrub can reach
    rows["scrub"]["copy_ms"] = time_ms(lambda: images.clone())

    # scrub where the main path launches it: the US chunk with recompression
    # off, its device's rects in the executor's power-of-two rect bucket
    R_us = bucket(len(us_rects))
    us = torch.from_numpy(full_range((32, uH, uW), np.uint8)).cuda()
    us_r = torch.from_numpy(pack_rects([us_rects] * 32, R=R_us)).cuda()
    us_mask = rect_mask(us_r, uH, uW)
    compare("scrub", scrub_images(us, us_r), scrub_ref(us, us_r), "US launched shape")
    npx = us.numel()
    rows["scrub"]["launched"] = [launched_row(
        f"(32,{uH},{uW}) uint8, R={R_us} ({len(us_rects)} rects)",
        (tuple(us.shape), "uint8", R_us), lambda: scrub_images(us, us_r),
        npx * (1 + 1) + us_r.numel() * 4, scrub_ops(32, uH, uW, R_us),
        library=lambda: us.masked_fill(us_mask, 0))]
    rows["scrub"]["launched"][0]["copy_ms"] = time_ms(lambda: us.clone())
    # one block's launch: the floor of any time taken this way
    one = torch.zeros((1, 1, 16), dtype=torch.uint16, device="cuda")
    one_r = torch.zeros((1, 1, 4), dtype=torch.int32, device="cuda")
    rows["scrub"]["floor_ms"] = time_ms(lambda: scrub_images(one, one_r))
    log(f"  scrub one-block launch (1,1,16): {rows['scrub']['floor_ms']} ms")
    return rows


def check_detector_kernels(us_shape) -> dict:
    """textdetect (all three outputs) and phi_detect against their plain
    versions, exact, at the detector path's chunk shapes, and phi_detect at
    its edge cases; timed at the CT chunk, and phi_detect at the audit's
    one-image shapes too."""
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
    log(f"phi_detect: {check_phi_edges()} edge cases equal to the plain version")
    log(f"textdetect: {check_text_edges()} edge cases equal to the plain version")

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

    # phi_detect where the audit launches it: one image of the unknown CT
    # and of the unknown DX a call
    rows["phi_detect"]["launched"] = []
    for shape in ((1, 320, 512), (1, 520, 648)):
        img = torch.from_numpy(banners(shape, np.uint16, 4095.0)).cuda()
        compare("phi_detect", edge_density(img, thresh=et), edge_density_ref(img, et, (th, tw)),
                f"audit shape {shape}")
        tiles1 = -(-shape[1] // th) * -(-shape[2] // tw)
        rows["phi_detect"]["launched"].append(launched_row(
            f"{shape} uint16, tile ({th},{tw})", (shape, "uint16", (th, tw)),
            lambda img=img: edge_density(img, thresh=et),
            img.numel() * 2 + tiles1 * 4, img.numel() * 4, FP32_OPS_PER_S))
    one = torch.zeros((1, 1, 16), dtype=torch.uint16, device="cuda")
    rows["phi_detect"]["floor_ms"] = time_ms(lambda: edge_density(one, thresh=et))
    log(f"  phi_detect one-block launch (1,1,16): {rows['phi_detect']['floor_ms']} ms")
    return rows


def bitmap_program(k: int, n_ops: int):
    """n_ops ops over k leaves for timing: the leaves ANDed in turn (the last
    the validity leaf, as ``compile_query`` ends), NOTs after the first leaf
    to make up the count."""
    used = max(min(k, (n_ops + 1) // 2), 1)
    prog = [("leaf", 0)]
    for i in range(1, used):
        prog += [("leaf", i), ("and",)]
    return tuple(prog[:1] + [("not",)] * (n_ops - len(prog)) + prog[1:])


def check_bitmap_kernel() -> dict:
    """The bitmap combine against its plain version, exact (bitmap and
    count), at the 2^22-row full scan of path (d) and its variants, and
    programs longer (65, 1000, 5000 ops) and deeper (40 nested And/Or) than
    one launch takes, through the wrapper's schedule; timed at the full scan
    (K = 4 leaves + validity) and at one word (the floor of a time taken
    this way)."""
    from repro_torch.kernels.bitmap.cases import chain, nested, random_program
    from repro_torch.kernels.bitmap.ops import (
        combine_bitmaps,
        combine_bitmaps_launch,
        combine_bitmaps_torch,
        pack_mask,
        program_depth,
        program_limits,
        schedule_program,
    )

    rng = np.random.default_rng(13)
    n_full = CATALOG_ACCESSIONS * CATALOG_INSTANCES

    def leaves_of(n, k):
        masks = [rng.random(n) < rng.random() for _ in range(k)] + [rng.random(n) < 0.95]
        return torch.stack([pack_mask(torch.from_numpy(m).cuda()) for m in masks])

    max_ops, max_depth = program_limits()

    def case(what, leaves, prog, want_count=None):
        got, count = combine_bitmaps(leaves, prog)
        want, plain_count = combine_bitmaps_torch(leaves, prog)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want) or count != int(plain_count):
            raise AssertionError(f"bitmap kernel != plain version on {what}")
        if want_count is not None and count != want_count:
            raise AssertionError(f"bitmap count {count} != {want_count} on {what}")
        launches = len(schedule_program(prog, max_ops, leaves.shape[0]))
        log(f"  equal: {what}: {len(prog)} ops, {program_depth(prog)} deep, {launches} "
            f"launch(es), count {count}")

    full = leaves_of(n_full, 4)
    case(f"W={full.shape[1]} (n=2^22), K=4+1", full, chain(4))
    case("ragged n=2^22-5, K=4+1", leaves_of(n_full - 5, 4), chain(4))
    case("n=2^22, K=1+1", leaves_of(n_full, 1), chain(1))
    eight = leaves_of(n_full, 8)
    case("n=2^22, K=8+1", eight, chain(8))
    n = n_full - 5
    empty_and_valid = torch.stack([pack_mask(torch.zeros(n, dtype=torch.bool, device="cuda")),
                                   pack_mask(torch.ones(n, dtype=torch.bool, device="cuda"))])
    case("not-rooted, n=2^22-5 (tail bits stay out)", empty_and_valid,
         (("leaf", 0), ("not",), ("leaf", 1), ("and",)), want_count=n)
    # past one launch (max_ops ops, max_depth deep): scheduled, split
    for n_ops in (65, 1000, 5000):
        case(f"random program, n=2^22, K=8+1 (one launch takes {max_ops} ops)", eight,
             random_program(rng, n_ops, 8))
    case(f"40-deep And/Or nesting, n=2^22-5, K=8+1 (one launch takes {max_depth} deep)",
         leaves_of(n, 8), nested(40, 8))
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
    one = leaves_of(1, 1)
    row["floor_ms"] = time_ms(lambda: combine_bitmaps_launch(one, chain(1)))
    log(f"time bitmap: {json.dumps(row)}; one-word launch {tuple(one.shape)}: {row['floor_ms']} ms")
    return {"bitmap": row}


def bitmap_launched_at(key) -> dict:
    """bitmap timed at a launch its wrapper counted on a path: ``key`` is
    ((K, W), dtype, ops) as ``LAUNCH_SHAPES`` holds it; random words, the
    program of ``bitmap_program``."""
    from repro_torch.kernels.bitmap.ops import combine_bitmaps_launch

    (K, W), _, n_ops = key
    rng = np.random.default_rng(21)
    leaves = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(K, W), dtype=np.int64)
                              .astype(np.int32)).cuda()
    prog = bitmap_program(K, n_ops)
    return launched_row(f"({K},{W}) int32 words, {n_ops} ops", key,
                        lambda: combine_bitmaps_launch(leaves, prog), (K + 1) * W * 4,
                        (n_ops + 1) * W)


def check_jls_kernel(us_shape) -> dict:
    """Kernel 8, the JPEG-Lossless predictor, against its plain version
    (``torch.equal``) at the CT chunk and the DX and US stacks (every sv), a
    full-range uint16 stack, every sv at a small ragged shape in uint8 and
    uint16, the edges H = 1, W = 1 and W = 257, and every layout of
    ``kernels/fused/cases.py`` (shapes x offsets x sv, uint8 and uint16);
    the launch refusals. Timed at all three stacks, where path (f) launches
    it (the CT chunk is its row); then the staged scrub -> jls pair against
    the fused kernel at the CT chunk with R = 2."""
    from repro_torch.kernels.fused import cases as fused_cases
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
    # the layouts of the strip walker shared with fused: ragged rows and
    # batches cut off 16 bytes take the pixel path
    n_layouts = 0
    for dtype in fused_cases.DTYPES:
        for shape in fused_cases.SHAPES:
            for offset in fused_cases.OFFSETS:
                planes = torch.from_numpy(fused_cases.planes(rng, dtype, shape)).cuda()
                images = planes[offset:offset + shape[0]]
                bits = images.element_size() * 8
                for sv in fused_cases.SVS:
                    got, want = jls_residuals(images, sv=sv), residuals_ref(images, sv, bits)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"jls kernel != plain version on fused case {shape} "
                                             f"{np.dtype(dtype).name} offset {offset} sv {sv}")
                    n_layouts += 1
    log(f"  equal: {n_layouts} fused/cases.py layouts (shapes x offsets x sv, uint8 and uint16)")
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
        dtype = str(images.dtype).removeprefix("torch.")
        # one read of the plane, one int32 write; ~12 integer operations a
        # pixel (predictor, wrap, neighbour bookkeeping)
        rows[name] = launched_row(f"{tuple(images.shape)} {dtype}, sv=1",
                                  (tuple(images.shape), dtype, 1),
                                  lambda images=images: jls_residuals(images, sv=1),
                                  npx * (images.element_size() + 4), npx * 12)
    ct_row = dict(rows["CT"])
    ct_row.update({
        "plain_ms": time_ms(lambda: residuals_ref(stacks["CT"], 1, 16)),
        "library_ms": None,  # no single PyTorch call computes the residuals
        "max_abs_err": 0,
        "launched": list(rows.values()),
    })

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
    return {"jls": ct_row}


# the serve cells' decode shapes: 32 rows, a 2,304-position cache, pos 2,303
DECODE_ATTN_SHAPES = {"qwen2-0.5b": (32, 2304, 2, 7, 64, 1 / 8), "granite-4.0-h-small": (32, 2304, 8, 4, 128, 1 / 128)}


def check_decode_attn() -> dict:
    """The decode-attention kernel (it replaces no TPU kernel; its plain
    version is ``models/attention.py::_decode_core``) against the plain
    version at the serve cells' decode shapes in bf16, with q drawn so the
    scores spread (standard deviation 2) and within 2^-6 of the largest
    output (an output's bf16 rounding, up to 2^-7 of it, and a probability at
    a bf16 rounding boundary rounding one ulp apart; the reasons in full:
    ``tests/test_torch_decode_attn.py``), where a wrong KV head and the mean
    of V must miss by 8 such limits or more; then timed there beside its
    bound (the K/V rows up to pos, q and the output, at 3.35 TB/s), the plain
    version and two yardsticks the port never calls:
    ``F.scaled_dot_product_attention`` over the same positions, and one
    PyTorch sum of each cache's rows up to pos (the same bytes read with no
    arithmetic)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.models.attention import _decode_core

    rows = {}
    g = torch.Generator("cuda").manual_seed(30)
    for name, (B, S, KV, G, hd, scale) in DECODE_ATTN_SHAPES.items():
        k, v = (torch.randn(B, S, KV, hd, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        q = (2 / (scale * hd ** 0.5) * torch.randn(B, KV, G, hd, generator=g, device="cuda")).to(torch.bfloat16)
        pos = S - 1
        got = decode_attn(q, k, v, pos, window=0, scale=scale)
        plain = _decode_core(q, k, v, pos, 0, scale).to(torch.bfloat16).float()
        limit = 2 ** -6 * plain.abs().max().item()
        err = (got.float() - plain).abs().max().item()
        faults = {"next_kv_head": _decode_core(q, k.roll(1, dims=2), v, pos, 0, scale).to(torch.bfloat16),
                  "mean_of_v": v[:, :pos + 1].float().mean(1)[:, :, None, :].expand(q.shape)}
        misses = {f: (wrong.float() - plain).abs().max().item() / limit for f, wrong in faults.items()}
        if err > limit or min(misses.values()) <= 8:
            raise AssertionError(f"decode_attn at {name}'s shape: error {err} against limit {limit}; "
                                 f"planted faults miss by {misses} limits")
        nbytes = 2 * B * (pos + 1) * KV * hd * 2 + 2 * q.numel() * 2
        qh, kh, vh = q.reshape(B, KV * G, 1, hd), k[:, :pos + 1].transpose(1, 2), v[:, :pos + 1].transpose(1, 2)
        row = {"shape": [B, S, KV, G, hd], "pos": pos, "max_abs_err": err, "limit": limit,
               "err_over_limit": err / limit, "faults_over_limit": misses,
               "ms": time_ms(lambda: decode_attn(q, k, v, pos, window=0, scale=scale)),
               "bound_ms": bound(nbytes, 0)[0],
               "plain_ms": time_ms(lambda: _decode_core(q, k, v, pos, 0, scale)),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale,
                                                                            enable_gqa=True)),
               "read_ms": time_ms(lambda: (k[:, :pos + 1].sum(), v[:, :pos + 1].sum()))}
        row["pct_of_bound"] = 100 * row["bound_ms"] / row["ms"]
        rows[name] = row
        log(f"decode_attn at {name}'s decode shape: {json.dumps(row)}")
    return rows


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
    Returns the launch counts, what ``during`` returned, and the launches
    its wrappers counted by shape (``LAUNCH_SHAPES``) in each kernel-path
    job, by the job's label, and in ``during``, as "during"."""
    from repro_torch.kernels import LAUNCH_SHAPES, LAUNCHES, reset_launches
    from repro_torch.obs.trace import Tracer

    tracers = [Tracer(_WallClock()) for _ in jobs]
    reset_launches()
    kernel_runs, by_job = [], {}
    for job, tr in zip(jobs, tracers):
        before = Counter(LAUNCH_SHAPES)
        kernel_runs.append(drive(make_pipeline("kernel", job[1], job[2], tr), job[0], pseudo))
        by_job[job_label(job)] = Counter(LAUNCH_SHAPES) - before
    before = Counter(LAUNCH_SHAPES)
    extra = during(kernel_runs) if during is not None else None
    by_job["during"] = Counter(LAUNCH_SHAPES) - before
    launches = dict(LAUNCHES)
    log(f"{name} path launches: {json.dumps(launches)}")
    for label, shapes in by_job.items():
        log(f"  {label}: launches by shape {json.dumps(sorted(map(list, shapes.items()), key=str))}")
    for k in kernels:
        assert launches[k] > 0, f"kernel {k} never launched on the {name} path"
    host_runs = [drive(make_pipeline("host", rc, mode), s, pseudo) for s, rc, mode in jobs]
    for job, k_run, h_run, tr in zip(jobs, kernel_runs, host_runs, tracers):
        check_equal(job, k_run, h_run, tr)
    return launches, extra, by_job


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


def run_detector_path(jobs, n_audited, pseudo):
    """The detector path; its first ``n_audited`` jobs are audited. Returns
    the launch counts and the launches by shape of each job and of the
    audit ("during"), as :func:`run_path` does."""
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
    launches, card_flags, by_job = run_path("detector", jobs, pseudo,
                                    DETECTOR_KERNELS + ("fused", "rice_prepass", "rice_len_rem"),
                                    during=audit_on_card)
    cpu_flags = audit(audited["runs"], "cpu")
    for label, (raw, delivered) in card_flags.items():
        assert (raw, delivered) == cpu_flags[label], f"audit on the card != CPU: {label}"
        assert not any(delivered), f"a delivered instance failed the audit: {label}"
        assert any(raw), f"no raw instance flagged (negative control): {label}"
        log(f"audit {label}: raw flagged {sum(raw)}/{len(raw)}, delivered flagged "
            f"{sum(delivered)}/{len(delivered)}; equal to the CPU")
    return launches, by_job


def run_encode_path(studies) -> dict:
    """Path (f), the kernel-assisted encode: ``encode_batch`` (jls kernel)
    and ``fused_encode_batch`` (fused kernel, the study's PHI rects) over
    each study's stack in 32-plane chunks, in a counted window; every
    payload byte-equal to the host ``codec.encode`` of its plane (blanked,
    for the fused encode). Then MB/s of ``encode_batch`` against the host
    ``codec.encode`` loop, ROUNDS alternating runs. Returns the launches and
    the launches its wrappers counted by shape (``LAUNCH_SHAPES``), as
    "encode"."""
    from repro_torch.core.scrub import numpy_blank
    from repro_torch.dicom import codec
    from repro_torch.kernels import LAUNCH_SHAPES, LAUNCHES, reset_launches
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
    launches, shapes = dict(LAUNCHES), Counter(LAUNCH_SHAPES)
    log(f"encode path launches: {json.dumps(launches)}; by shape "
        f"{json.dumps(sorted(map(list, shapes.items()), key=str))}")
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
    return {"launches": launches, "shapes": {"encode": shapes}}


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


# ---------------------------- phase 3: the scenario suite, the fleet, the farm
ROOT = Path(__file__).resolve().parent


def run_scenario_path() -> dict:
    """Path (i), the paper's Figure 2b suite: every ``tests/features`` file
    through ``run_feature(device="cuda")`` in a counted window, then with
    ``device="cpu"``. Every scenario must pass on the card, with the CPU
    run's results, and each instance is blanked by the scrub kernel."""
    from repro_torch.core.scenarios import VirtualDicomTree, parse_feature, run_feature
    from repro_torch.kernels import LAUNCHES, reset_launches

    features = sorted((ROOT / "tests" / "features").glob("*.feature"))
    assert features, "no feature files under tests/features"

    def run(device):
        return {p.name: [(r.scenario, r.passed, r.detail) for r in
                         run_feature(parse_feature(p.read_text()), VirtualDicomTree(), device=device)]
                for p in features}

    reset_launches()
    t0 = time.perf_counter()
    card = run("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    cpu = run("cpu")
    cpu_wall = time.perf_counter() - t0
    failed = [(f, r) for f, rs in card.items() for r in rs if not r[1]]
    assert not failed, f"scenarios failed on the card: {failed}"
    assert card == cpu, "scenario results on the card differ from device='cpu'"
    assert launches["scrub"] > 0, "kernel scrub never launched on the scenario path (i)"
    n = sum(len(rs) for rs in card.values())
    log(f"scenarios (i): {n} scenarios in {len(features)} feature files pass on the card, equal "
        f"to device='cpu'; wall s card {wall} cpu {cpu_wall}; launches {json.dumps(launches)}")
    return launches


# path (j): a fleet an operator would call small but real, under every chaos
# kind, and a smaller one with recompression off (the FleetConfig default),
# which blanks through the scrub kernel. (j) is cut from 8 images a study to
# 2: each fetch and store of a study is the at-rest XOR, a Python byte loop
# over its bytes (PERF.md section 4).
FLEET_TRAFFIC = dict(n_bursts=3, cohorts_per_burst=2, cohort_size=6)
FLEET_QUERIES = 6
FLEET_CHAOS = dict(crash_events=2, straggler_events=1, reingests=2, lease_storms=1,
                   ruleset_edits=1, pooler_crashes=1, feed_outages=1, feed_faults=1)
FLEETS = {
    "j": (dict(seed=7, n_studies=24, images_per_study=2, modality=None, recompress=True,
               unknown_device_rate=0.25, feed_mutations=8),
          ("fused", "rice_prepass", "rice_len_rem", "bitmap", "textdetect")),
    "j-scrub": (dict(seed=7, n_studies=8, images_per_study=2, modality=None, recompress=False,
                     unknown_device_rate=0.25, feed_mutations=8),
                ("scrub", "bitmap", "textdetect")),
}
FLEET_TIMED = (("pipeline.run_study", "repro_torch.core.pipeline", "DeidPipeline", "run_study"),
               ("executor.run", "repro_torch.core.batch", "BatchedDeidExecutor", "run"),
               ("executor.submit_kernel", "repro_torch.core.batch", "BatchedDeidExecutor",
                "_submit_kernel"),
               ("executor.collect", "repro_torch.core.batch", "BatchedDeidExecutor",
                "_collect_chunk"),
               ("executor.detect", "repro_torch.core.batch", "BatchedDeidExecutor",
                "detect_row_hits"),
               # the at-rest XOR of every study read and write, and the checkers
               ("store.get_study", "repro_torch.storage.object_store", "StudyStore", "get_study"),
               ("store.put_study", "repro_torch.storage.object_store", "StudyStore", "put_study"),
               ("report+checkers", "repro_torch.sim.harness", "FleetSim", "_report"))


def fleet_run(name: str, device: str, journal_dir: str, timed: bool = False) -> dict:
    """One ``FleetSim`` run of ``FLEETS[name]`` on ``device``: its report's
    digests, metrics and violations, digests of the researcher bucket and
    the result lake, and wall seconds. ``timed`` adds the wall seconds spent
    in ``run_study`` and in the executor's parts (``FLEET_TIMED``)."""
    import hashlib
    import importlib

    from repro_torch.obs.trace import host_path_digest
    from repro_torch.sim import BurstyTraffic, ChaosSchedule, FleetConfig, FleetSim, QueryMix

    cfg_kw, _ = FLEETS[name]
    cfg = FleetConfig(**cfg_kw)
    corpus = [f"SIM{i:04d}" for i in range(cfg.n_studies)]
    traffic = (BurstyTraffic(**FLEET_TRAFFIC).schedule(corpus, cfg.seed)
               + QueryMix(n_queries=FLEET_QUERIES).schedule(corpus, cfg.seed))
    chaos = ChaosSchedule.seeded(cfg.seed, 1800.0, corpus, **FLEET_CHAOS)
    spent, saved = Counter(), []
    if timed:
        for label, module, cls, meth in FLEET_TIMED:
            owner = getattr(importlib.import_module(module), cls)
            orig = getattr(owner, meth)

            def wrapped(*a, _orig=orig, _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **kw)
                finally:
                    spent[_label] += time.perf_counter() - t0

            saved.append((owner, meth, orig))
            setattr(owner, meth, wrapped)
    try:
        t0 = time.perf_counter()
        sim = FleetSim(cfg, traffic, Path(journal_dir) / f"{name}-{device}.jsonl", chaos,
                       device=device)
        report = sim.run()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for owner, meth, orig in saved:
            setattr(owner, meth, orig)

    def digest(items):
        h = hashlib.sha256()
        for key, etag in sorted(items):
            h.update(f"{key} {etag}\n".encode())
        return h.hexdigest()

    bucket = sim.dest.store
    lake = sim.lake

    return {"ok": report.ok(), "violations": [f"{v.checker}: {v.detail}" for v in report.violations],
            "log_digest": report.log_digest, "trace_digest": report.trace_digest,
            "host_path_trace_digest": host_path_digest(sim.tracer.spans()),
            "audit_digest": report.audit.get("digest"),
            "metrics": json.loads(json.dumps(report.metrics)),
            "bucket_digest": digest((p, bucket.etag(p)) for p in bucket.list("out/")),
            "lake_digest": digest((k, hashlib.sha256(lake.backend.get_bytes(k)).hexdigest())
                                  for k in lake.keys()),
            "spans": len(sim.tracer.spans()), "records": len(sim.log.records),
            "wall_s": wall, "spent_s": dict(spent)}


_FLEET_CHILD = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke
print(json.dumps(chip_smoke.fleet_run(sys.argv[1], "cpu", sys.argv[2])))
"""


def run_fleet_path() -> dict:
    """Path (j): each fleet of ``FLEETS`` on the card in a counted window,
    beside the same run with ``device="cpu"`` in a child process started
    just before it. Every default checker must be green on the card; the
    event-log and audit digests, the metrics and the bucket and lake
    digests must equal the CPU run's, and so must the trace digest once the
    executor spans' path labels are read as the host path's
    (``host_path_digest``): the card's spans say "fused" where the CPU's say
    "host", and nothing else differs. Returns the launches by fleet."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fleet-") as tmp:
        for name, (cfg_kw, kernels) in FLEETS.items():
            child = subprocess.Popen([sys.executable, "-c", _FLEET_CHILD, name, tmp], cwd=ROOT,
                                     stdout=subprocess.PIPE, text=True)
            try:
                reset_launches()
                card = fleet_run(name, "cuda", tmp, timed=True)
                launches = dict(LAUNCHES)
                stdout, _ = child.communicate(timeout=1200)
                if child.returncode != 0:
                    raise RuntimeError(f"fleet ({name}) on the CPU failed (rc {child.returncode})")
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
            cpu = json.loads(stdout.strip().splitlines()[-1])
            assert card["ok"], f"fleet ({name}) on the card: {card['violations']}"
            assert cpu["ok"], f"fleet ({name}) on the CPU: {cpu['violations']}"
            for key in ("log_digest", "audit_digest", "metrics", "bucket_digest", "lake_digest",
                        "spans", "records"):
                assert card[key] == cpu[key], f"fleet ({name}): {key} differs from device='cpu'"
            assert cpu["host_path_trace_digest"] == cpu["trace_digest"]
            assert card["host_path_trace_digest"] == cpu["trace_digest"], \
                f"fleet ({name}): trace differs from device='cpu' beyond the path labels"
            for k in kernels:
                assert launches[k] > 0, f"kernel {k} never launched on the fleet path ({name})"
            spent = card["spent_s"]
            share = {k: v / spent["pipeline.run_study"] for k, v in spent.items()
                     if k.startswith("executor.")}
            log(f"fleet ({name}) {json.dumps(cfg_kw)}: green under every default checker on the "
                f"card; log, audit, bucket and lake digests, metrics and host-path trace digest "
                f"equal to device='cpu' (card trace digest {card['trace_digest'][:16]}, cpu "
                f"{cpu['trace_digest'][:16]}); {card['records']} log records, {card['spans']} "
                f"spans; wall s card {card['wall_s']} cpu {cpu['wall_s']} (the two runs overlap); "
                f"card wall s in (inclusive; run_study also runs inside the checkers' cold "
                f"replays) {json.dumps(spent)}, the executor's share of run_study "
                f"{json.dumps(share)}; "
                f"metrics {json.dumps(card['metrics'])}; launches {json.dumps(launches)}")
            out[name] = launches
    return out


def run_farm_path() -> dict:
    """Path (k): ``ScrubFarm()`` over every CUDA device, ``process_datasets``
    on a CT/DX/US batch, and ``ElasticFarmController`` over a pool of four
    entries naming ``cuda:0`` (resize to 4, to 2, fail entry 1, reconcile),
    each in a counted window and equal to ``numpy_blank`` per image. The
    elastic run checks the sharding and rebuild logic with the kernel; with
    one card it says nothing of several."""
    from repro_torch.core import DeidPipeline
    from repro_torch.core.scrub import numpy_blank
    from repro_torch.dicom.generator import StudyGenerator
    from repro_torch.distributed import ElasticFarmController, ScrubFarm
    from repro_torch.kernels import LAUNCHES, reset_launches

    gen = StudyGenerator(seed=11)
    studies = [gen.gen_study("FARM-CT", modality="CT", n_images=13),
               gen.gen_study("FARM-DX", modality="DX", n_images=3),
               gen.gen_study("FARM-US", modality="US", n_images=5)]
    datasets = [ds.copy() for s in studies for ds in s.datasets if ds.pixels is not None]
    before = [ds.pixels.copy() for ds in datasets]
    rects_for = DeidPipeline(recompress=False, device="cpu").scrub.rects_for
    reset_launches()
    t0 = time.perf_counter()
    farm = ScrubFarm()
    applied = farm.process_datasets(datasets, rects_for)
    wall = time.perf_counter() - t0
    farm_launches = dict(LAUNCHES)
    assert applied and farm_launches["scrub"] > 0, "kernel scrub never launched on the farm path"
    for i, ds in enumerate(datasets):
        want = numpy_blank(before[i], applied[i]) if i in applied else before[i]
        assert np.array_equal(ds.pixels, want), f"farm: dataset {i} differs from numpy_blank"

    ct = np.stack(before[:13])
    rl = [list(rects_for(ds)) for ds in studies[0].datasets[:13]]
    ref = np.stack([numpy_blank(ct[i], rl[i]) for i in range(len(rl))])
    reset_launches()
    c = ElasticFarmController([torch.device("cuda:0")] * 4)
    steps = []
    for step in ("reconcile 4", "reconcile 2", "mark_failed 1", "reconcile 2"):
        verb, arg = step.split()
        if verb == "mark_failed":
            c.mark_failed(int(arg))
            continue
        f = c.reconcile(int(arg))
        assert np.array_equal(f.scrub_batch(ct, rl), ref), f"elastic farm after {step}"
        steps.append((step, c.active, list(c.members)))
    elastic_launches = dict(LAUNCHES)
    assert [s[1:] for s in steps] == [(4, [0, 1, 2, 3]), (2, [0, 1]), (2, [0, 2])], steps
    assert [e.kind for e in c.events] == ["resize", "resize", "device-failure", "resize"]
    assert elastic_launches["scrub"] > 0
    log(f"farm (k): ScrubFarm over {farm.n} CUDA device(s), {len(datasets)} CT/DX/US instances in "
        f"{len(applied)} scrubbed, equal to numpy_blank; wall s {wall}; launches "
        f"{json.dumps(farm_launches)}; elastic over 4 entries naming cuda:0 {steps}, equal to "
        f"numpy_blank at each step, launches {json.dumps(elastic_launches)}")
    return {"farm": farm_launches, "elastic": elastic_launches}


# ------------------------------------------------- phase 3: LM serving (l)
# path (l): qwen2-0.5b at its full width and depth (24 layers, d 896, 14/2
# heads, vocab 151936), bf16, weights drawn from seed 0 on the card; 8
# requests, prompts of 64-512 tokens from the seed, 32 greedy new tokens each
LM_ARCH = "qwen2-0.5b"
LM_REQUESTS = 8
LM_PROMPT_RANGE = (64, 512)
LM_MAX_NEW = 32
BF16_OPS_PER_S = hw.PEAK_FLOPS_BF16  # dense bf16 tensor rate
# card against CPU, every family reduced: dense, sliding window, MoE, SSM,
# hybrid through ServeEngine; the VLM and the encoder through prefill
LM_SERVED = ("qwen2-0.5b", "h2o-danube-1.8b", "mixtral-8x22b", "olmoe-1b-7b",
             "falcon-mamba-7b", "zamba2-2.7b")
LM_PREFILLED = ("llava-next-34b", "hubert-xlarge")
LM_REDUCED_TOL = dict(atol=1e-4, rtol=1e-4)  # f32 activations, TF32 off (PyTorch's default)
LM_FULL_TOL = dict(atol=1e-3, rtol=1e-3)


def _lm_engine(model, prompts, max_new, max_batch):
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(model, max_batch=max_batch)
    for i, (prompt, m) in enumerate(zip(prompts, max_new)):
        eng.submit(Request(f"r{i}", prompt, max_new_tokens=m))
    return eng


def _lm_timed_serve(model, prompts, max_new) -> dict:
    """One ``ServeEngine.run`` with the model's prefill and decode steps each
    timed on the host clock between two ``torch.cuda.synchronize()``."""
    spent = {"prefill": [], "decode": []}
    eng = _lm_engine(model, prompts, [max_new] * len(prompts), len(prompts))

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t0)
            return out
        return call

    model.prefill, model.decode_step = timed("prefill", model.prefill), timed("decode", model.decode_step)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.run()
        wall = time.perf_counter() - t0
    finally:
        del model.prefill, model.decode_step
    return {"tokens": [r.tokens for r in results], "wall_s": wall, **spent}


def _lm_trace(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CUPTI): its wall time on
    the host clock (synchronized; the profiler's own cost included), the
    card's busy time (the union of its kernel, copy and fill intervals), the
    idle share that leaves, the kernels launched, the six ops with the most
    host self time, and the eight kernels (by name) with the most device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-lm-") as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:6]
    kernel_us = Counter()
    for e in events:
        if e.get("cat") == "kernel":
            kernel_us[e["name"][:60]] += e["dur"]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us if spans else None,
            "kernels": sum(1 for e in events if e.get("cat") == "kernel"),
            "host_self_ms_top": [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in top],
            "kernel_ms_top": [(name, us / 1e3) for name, us in kernel_us.most_common(8)]}


def _lm_full_width_bf16() -> dict:
    """(l) 1: qwen2-0.5b at full width in bf16 on the card, served; times
    against their bounds."""
    from repro_torch.config import get_arch
    from repro_torch.models import build_model

    cfg = get_arch(LM_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda:0", generator=torch.Generator("cuda:0").manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size) == (24, 896, 14, 2, 151936)
    assert n_params == cfg.param_count() and model.layers.attn.wq.dtype == torch.bfloat16

    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT_RANGE[0], LM_PROMPT_RANGE[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    P = int(lens.max())
    _lm_timed_serve(model, prompts, 4)  # warm-up: cuBLAS handles, allocator
    torch.cuda.reset_peak_memory_stats()
    run = _lm_timed_serve(model, prompts, LM_MAX_NEW)
    peak = torch.cuda.max_memory_allocated()
    again = _lm_timed_serve(model, prompts, LM_MAX_NEW)
    assert run["tokens"] == again["tokens"], "greedy serving on the card is not deterministic"
    assert all(len(t) == LM_MAX_NEW and all(0 <= x < cfg.vocab_size for x in t) for t in run["tokens"])
    assert len(run["prefill"]) == 1 and len(run["decode"]) == LM_MAX_NEW - 1

    # where a step's time goes: the prefill and one decode step of the same
    # batch, traced; the step replayed (the served path: the cache the model
    # holds for the batch's shape, its graph captured while serving) and the
    # same step run eagerly on a cache of its own
    toks = torch.zeros((LM_REQUESTS, P), dtype=torch.int64)
    for i, prompt in enumerate(prompts):
        toks[i, P - len(prompt):] = torch.tensor(prompt)
    held = {}
    trace_prefill = _lm_trace(lambda: held.update(zip(("logits", "cache"), model.prefill({"tokens": toks}))))
    cache = model.grow_cache(held["cache"], P, P + LM_MAX_NEW)
    own = {name: t.clone() for name, t in cache.items()}
    first = held["logits"].argmax(-1)
    model.decode_step(first, cache, P)
    model.decode_step(first, own, P)
    paths = (model.decode_graphs_captured, model.decode_steps_replayed, model.decode_steps_eager)
    trace_decode = _lm_trace(lambda: model.decode_step(first, cache, P + 1))
    trace_eager = _lm_trace(lambda: model.decode_step(first, own, P + 1))
    assert (model.decode_steps_replayed, model.decode_steps_eager) == (paths[1] + 1, paths[2] + 1), \
        "the traced steps did not take the replayed and the eager path"

    # bounds: prefill 2 x params x prompt tokens (the B x P padded tokens it
    # computes) at the dense bf16 rate; a decode step reads every weight and
    # the K/V of the positions up to its own once
    B, KV, hd, L = LM_REQUESTS, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    prefill_bound_ms = 2 * n_params * B * P / BF16_OPS_PER_S * 1e3
    kv_bytes = [2 * L * B * (P + s) * KV * hd * 2 for s in range(1, LM_MAX_NEW)]
    decode_bound_ms = [(weight_bytes + b) / HBM_BYTES_PER_S * 1e3 for b in kv_bytes]
    new_tokens = sum(len(t) for t in run["tokens"])
    out = {
        "arch": LM_ARCH, "params": n_params, "weight_bytes": weight_bytes, "build_s": build_s,
        "requests": B, "prompt_lens": [int(n) for n in lens], "P": P, "max_new": LM_MAX_NEW,
        "prefill_ms": run["prefill"][0] * 1e3, "prefill_ms_again": again["prefill"][0] * 1e3,
        "prefill_bound_ms": prefill_bound_ms,
        "decode_ms_per_step": statistics.median(run["decode"]) * 1e3,
        "decode_ms_per_step_again": statistics.median(again["decode"]) * 1e3,
        "decode_ms_min": min(run["decode"]) * 1e3, "decode_ms_max": max(run["decode"]) * 1e3,
        "decode_bound_ms_per_step": statistics.median(decode_bound_ms),
        "serve_wall_s": run["wall_s"], "new_tokens": new_tokens,
        "tokens_per_s": new_tokens / run["wall_s"],
        "peak_bytes": peak, "trace_prefill": trace_prefill, "trace_decode_step": trace_decode,
        "trace_decode_step_eager": trace_eager,
        "decode_paths": {"captured": model.decode_graphs_captured, "replayed": model.decode_steps_replayed,
                         "eager": model.decode_steps_eager},
        "card": card_line(),
    }
    out["prefill_pct_of_bound"] = 100 * prefill_bound_ms / out["prefill_ms"]
    out["decode_pct_of_bound"] = 100 * out["decode_bound_ms_per_step"] / out["decode_ms_per_step"]
    return out


def _lm_full_width_f32() -> dict:
    """(l) 2: the same architecture under dtype="float32", the weights built
    on the CPU and copied to the card; prefill + 4 greedy decode steps of 2
    prompts of 64 tokens on both."""
    import copy

    from repro_torch.config import get_arch
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch(LM_ARCH), dtype="float32")
    cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(1))
    card = copy.deepcopy(cpu).to("cuda:0")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64))
    errs, toks = [], []
    (lc, cc), (lg, cg) = cpu.prefill({"tokens": tokens}), card.prefill({"tokens": tokens})
    cc, cg = cpu.grow_cache(cc, 64, 68), card.grow_cache(cg, 64, 68)
    for step in range(5):
        got, want = lg.cpu().numpy(), lc.numpy()
        np.testing.assert_allclose(got, want, **LM_FULL_TOL, err_msg=f"full-width f32, step {step}")
        errs.append(float(np.abs(got - want).max()))
        tok_g, tok_c = got.argmax(-1), want.argmax(-1)
        assert np.array_equal(tok_g, tok_c), f"full-width f32 greedy tokens differ at step {step}"
        toks.append(tok_c.tolist())
        if step < 4:
            lc, cc = cpu.decode_step(tok_c, cc, 64 + step)
            lg, cg = card.decode_step(tok_c, cg, 64 + step)
    return {"max_abs_err": errs, "tokens": toks}


def _lm_reduced_families() -> dict:
    """(l) 3 and 4: every family reduced, card against CPU on the same
    weights; then falcon-mamba with B == P."""
    import copy

    from repro_torch.config import get_arch
    from repro_torch.models import build_model

    out = {}
    for arch in LM_SERVED + LM_PREFILLED:
        cfg = get_arch(arch).reduced()
        cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
        card = copy.deepcopy(cpu).to("cuda:0")
        rng = np.random.default_rng(2)
        if cfg.family == "encoder":
            batch = {"frame_embeds": rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)}
        elif cfg.family == "vlm":
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)),
                     "patch_embeds": rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)}
        else:
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32))}
        got, want = card.prefill(batch)[0].cpu().numpy(), cpu.prefill(batch)[0].numpy()
        np.testing.assert_allclose(got, want, **LM_REDUCED_TOL, err_msg=f"{arch} prefill")
        row = {"prefill_max_abs_err": float(np.abs(got - want).max())}
        if arch in LM_SERVED:
            prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (64, 17, 40, 33, 64, 8)]
            max_new = [12, 12, 5, 12, 7, 12]
            t_card = [r.tokens for r in _lm_engine(card, prompts, max_new, 3).run()]
            t_cpu = [r.tokens for r in _lm_engine(cpu, prompts, max_new, 3).run()]
            assert t_card == t_cpu, f"{arch}: greedy tokens on the card differ from the CPU"
            row["tokens"] = sum(len(t) for t in t_card)
        out[arch] = row

    # the cache growth the reference gets wrong: B == P = 4 on falcon-mamba
    cfg = get_arch("falcon-mamba-7b").reduced()
    cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda:0")
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16]]
    t_card = [r.tokens for r in _lm_engine(card, prompts, [3] * 4, 4).run()]
    assert t_card == [r.tokens for r in _lm_engine(cpu, prompts, [3] * 4, 2).run()], \
        "falcon-mamba at B == P on the card differs from the CPU at B != P"
    out["falcon-mamba-7b B == P"] = {"tokens": t_card}
    return out


def run_lm_path() -> dict:
    """Path (l), LM serving: qwen2-0.5b at full width in bf16 on the card
    (times against bounds), the same architecture in f32 card against CPU,
    every family reduced card against CPU, and falcon-mamba at B == P. Its
    decode steps launch the decode-attention kernel; the rest is plain
    PyTorch, like the reference's plain jnp: no other launch count moves."""
    from repro_torch.kernels import LAUNCHES

    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    bf16 = _lm_full_width_bf16()
    log(f"lm serving (l), {bf16['arch']} full width bf16 on the card: {json.dumps(bf16)}")
    f32 = _lm_full_width_f32()
    log(f"lm serving (l), {LM_ARCH} full width f32, card against CPU (atol/rtol 1e-3): "
        f"last-token logits max abs err by step {f32['max_abs_err']}, greedy tokens equal {f32['tokens']}")
    fam = _lm_reduced_families()
    log(f"lm serving (l), reduced families, card against CPU (atol/rtol 1e-4; greedy tokens "
        f"equal): {json.dumps(fam)}")
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    assert launched.pop("decode_attn") > 0 and not any(launched.values()), \
        f"path (l) launched port kernels: {before} -> {dict(LAUNCHES)}"
    log(f"lm serving (l): {time.perf_counter() - t0:.1f} s; kernel launches: decode_attn "
        f"{LAUNCHES['decode_attn'] - before['decode_attn']}, no other")
    return {"bf16": bf16, "f32": f32, "families": fam}


# --------------------------------------------------- phase 3: training (m)
# path (m1): `python -m repro_torch.launch.train --arch qwen2-0.5b --full` at
# B 8 x S 1024 (8192 tokens a step), bf16 with an f32 master copy, remat
# "full", lr 3e-4 cosine with 5 warm-up steps, weights from seed 0 drawn on
# the host; 2 warm-up steps (the second traced), then 10 timed
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARM, TRAIN_TIMED = 8, 1024, 2, 10
TRAIN_LR, TRAIN_WARMUP = 3e-4, 5
# (m3): every family reduced, card against CPU, 3 steps each
TRAIN_FAMILIES = {"dense": "qwen2-0.5b", "sliding window": "h2o-danube-1.8b", "moe": "olmoe-1b-7b",
                  "ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b", "vlm": "llava-next-34b",
                  "encoder": "hubert-xlarge"}
TRAIN_TOL = 1e-4  # losses (atol and rtol), gnorm and weights (relative per leaf), card against CPU


def _train_flops(cfg, B: int, S: int) -> dict:
    """FLOPs of one train step, from the code: 6 x the matmul parameters x
    tokens (forward 2, backward 4; the tied head counted once, the embedding
    lookup none), plus causal attention's QK^T and PV over the S(S+1)/2
    pairs a head keeps, three times (forward, backward); and what remat
    "full" recomputes beside them: each layer's forward once more and each
    CE chunk's head product."""
    d, H, KV, hd, f, V, L = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    layer = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * f
    tokens = B * S
    attn_fwd = L * B * H * 4 * hd * S * (S + 1) // 2
    model = 6 * (L * layer + d * V) * tokens + 3 * attn_fwd
    recompute = 2 * L * layer * tokens + attn_fwd + 2 * d * V * tokens
    return {"matmul_params": L * layer + d * V, "model_flops": model, "recompute_flops": recompute}


def _train_full_width_bf16(tmp: str) -> dict:
    """(m1): the training launcher at full width on the card, its steps
    timed between synchronizes, one traced, its checkpoint save timed."""
    from repro_torch.config import get_arch
    from repro_torch.launch import train as launch_train

    steps = TRAIN_WARM + TRAIN_TIMED
    spent, metrics, last, trace, saves = [], [], {}, {}, []
    make_step, manager = launch_train.make_train_step, launch_train.CheckpointManager

    def timed_factory(model, sched, **kw):
        step = make_step(model, sched, **kw)
        last["model"] = model

        def call(state, batch):
            if len(metrics) == TRAIN_WARM - 1:  # the second warm-up step, traced
                held = {}
                trace.update(_lm_trace(lambda: held.update(out=step(state, batch))))
                out = held["out"]
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                spent.append(time.perf_counter() - t0)
            metrics.append(out[1])
            last["state"] = out[0]
            return out
        return call

    class TimedManager(manager):
        def save(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = super().save(*a, **kw)
            saves.append(time.perf_counter() - t0)
            return path

    cfg = get_arch(LM_ARCH)
    launch_train.make_train_step, launch_train.CheckpointManager = timed_factory, TimedManager
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        result = launch_train.main(["--arch", LM_ARCH, "--full", "--steps", str(steps),
                                    "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                                    "--lr", str(TRAIN_LR), "--warmup", str(TRAIN_WARMUP),
                                    "--ckpt-every", "0", "--ckpt-dir", tmp, "--seed", "0"])
    finally:
        launch_train.make_train_step, launch_train.CheckpointManager = make_step, manager
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    assert result["device"] == "cuda:0" and result["steps"] == steps

    state = last["state"]
    losses = [float(m["loss"]) for m in metrics]
    assert len(losses) == steps and all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"full-width training: loss did not fall {losses}"
    n_params = sum(p.numel() for p in _leaves(state.params))
    assert n_params == cfg.param_count() == 494_032_768
    param_bytes = sum(p.numel() * p.element_size() for p in _leaves(state.params))
    opt_bytes = sum(t.numel() * t.element_size() for name in ("m", "v", "master")
                    for t in _leaves(getattr(state.opt, name)))
    assert all(p.dtype == torch.bfloat16 for p in _leaves(state.params))
    assert param_bytes == 2 * n_params and opt_bytes == 12 * n_params, (param_bytes, opt_bytes)

    split = _train_step_split(last["model"], state, cfg)
    timed = spent[-TRAIN_TIMED:]
    flops = _train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flop_ms = flops["model_flops"] / BF16_OPS_PER_S * 1e3
    # bytes a step must move at least: weights in and out, the AdamW state
    # (m, v, master) in and out, the batch
    byte_ms = (2 * param_bytes + 2 * opt_bytes + 2 * 4 * tokens) / HBM_BYTES_PER_S * 1e3
    step_ms = statistics.median(timed) * 1e3
    out = {"arch": LM_ARCH, "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "tokens_per_step": tokens, "losses": losses, "step_ms_median": step_ms,
           "step_ms_min": min(timed) * 1e3, "step_ms_max": max(timed) * 1e3,
           "tokens_per_s": tokens / statistics.median(timed), "peak_bytes": peak,
           "param_bytes": param_bytes, "grad_bytes": param_bytes, "opt_state_bytes": opt_bytes,
           **flops, "bound_ms": max(flop_ms, byte_ms), "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
           "byte_bound_ms": byte_ms, "recompute_ms_at_peak": flops["recompute_flops"] / BF16_OPS_PER_S * 1e3,
           "checkpoint_save_s": saves, "launcher_wall_s": wall, **split, "trace_step": trace,
           "card": card_line()}
    out["pct_of_bound"] = 100 * out["bound_ms"] / step_ms
    return out


def _train_step_split(model, state, cfg, reps: int = 3) -> dict:
    """A step's two halves on the launcher's model after its run, each
    between synchronizes, median of ``reps``: the loss with its backward
    pass, and the update (global-norm clip, AdamW, the weights written)."""
    from repro_torch.launch.train import batch_to_device
    from repro_torch.training import SyntheticTokenPipeline, adamw_update, clip_by_global_norm
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.train_step import _write_params

    batch = batch_to_device(SyntheticTokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=1).get_batch(0),
                            torch.device("cuda:0"))
    params, back, upd = _leaves(state.params), [], []
    opt = state.opt
    for _ in range(reps):
        for p in params:
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.loss(batch)[0].backward()
        torch.cuda.synchronize()
        back.append(time.perf_counter() - t0)
        grads = tree_map(lambda p: p.grad, state.params)
        for p in params:
            p.grad = None
        t0 = time.perf_counter()
        clipped, _ = clip_by_global_norm(grads, 1.0)
        new, opt = adamw_update(clipped, opt, torch.tensor(1e-5, device="cuda:0"))
        _write_params(state.params, new)
        torch.cuda.synchronize()
        upd.append(time.perf_counter() - t0)
        del grads, clipped, new
    return {"loss_and_backward_ms": statistics.median(back) * 1e3,
            "update_ms": statistics.median(upd) * 1e3}


def _leaves(tree):
    from repro_torch.training.optimizer import tree_leaves

    return tree_leaves(tree) if isinstance(tree, dict) else [tree]


def _train_pair(cfg, seed, compression=False):
    """The same weights and optimizer state on the CPU and on the card."""
    import copy

    from repro_torch.models import build_model
    from repro_torch.training import train_state_init

    cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(seed))
    card = copy.deepcopy(cpu).to("cuda:0")
    return [(m, train_state_init(m, compression=compression)) for m in (cpu, card)]


def _train_full_width_f32() -> dict:
    """(m2): qwen2-0.5b at full width in f32, depth cut to 4 layers, B 2 x
    S 128: 2 steps from the same weights on the card and on the CPU."""
    from repro_torch.config import get_arch
    from repro_torch.models.spec import tree_items
    from repro_torch.training import SyntheticTokenPipeline, cosine_schedule, make_train_step

    cfg = dataclasses.replace(get_arch(LM_ARCH), dtype="float32", n_layers=4)
    pipe = SyntheticTokenPipeline(cfg, 2, 128, seed=0)
    runs = []
    for model, state in _train_pair(cfg, seed=2):
        step = make_train_step(model, cosine_schedule(TRAIN_LR, TRAIN_WARMUP, 12))
        ms = []
        for i in range(2):
            state, m = step(state, pipe.get_batch(i))
            ms.append({k: float(v) for k, v in m.items()})
        runs.append((ms, state))
    (m_cpu, s_cpu), (m_card, s_card) = runs
    out = {"loss": [], "gnorm": [], "worst_master_rel": 0.0}
    for i, (a, b) in enumerate(zip(m_card, m_cpu)):
        for k in ("loss", "gnorm"):
            rel = abs(a[k] - b[k]) / abs(b[k])
            assert rel <= TRAIN_TOL, f"(m2) step {i} {k}: card {a[k]} cpu {b[k]}"
            out[k].append((a[k], b[k]))
    # every weight's f32 master copy (the bf16 weights are its rounding: a
    # master 1e-6 off may round one bf16 ulp, 4e-3 of an element, the other
    # way). A leaf drawn at init within 1e-4 relative (||card - cpu|| /
    # ||cpu||); a leaf that starts at zero (the QKV biases) holds nothing but
    # AdamW's normalised steps, which carry a gradient near zero (a sum that
    # cancels) to a step of up to lr whatever its rounding: each element
    # within AdamW's reach, 2 x lr summed over the steps
    lr_sum = sum(cosine_schedule(TRAIN_LR, TRAIN_WARMUP, 12)(torch.tensor(i)).item() for i in range(2))
    zero_init = {k.replace(".", "/") for k, spec in tree_items(model.param_specs()) if spec.init == "zeros"}
    out["zero_init_worst_over_reach"] = 0.0
    for (name, p), q in zip(_named(s_card.opt.master), _leaves(s_cpu.opt.master)):
        diff = p.double().cpu() - q.double()
        if name in zero_init:
            worst = float(diff.abs().max()) / (2 * lr_sum)
            assert worst <= 1.0, f"(m2) master {name} after step 2 beyond AdamW's reach: {worst}"
            out["zero_init_worst_over_reach"] = max(out["zero_init_worst_over_reach"], worst)
        else:
            rel = float(torch.linalg.norm(diff) / torch.linalg.norm(q.double()))
            assert rel <= TRAIN_TOL, f"(m2) master {name} after step 2: {rel}"
            out["worst_master_rel"] = max(out["worst_master_rel"], rel)
    return out


def _named(tree):
    from repro_torch.training.checkpoint import flatten_with_paths

    return list(flatten_with_paths(tree).items())


def _train_reduced_families(tmp: str) -> dict:
    """(m3): every family reduced, 3 steps card against CPU; 2 microbatches
    against 1 on the card; the launcher with --compression on the card."""
    from repro_torch.config import get_arch
    from repro_torch.launch import train as launch_train
    from repro_torch.training import SyntheticTokenPipeline, cosine_schedule, make_train_step

    out = {}
    for family, arch in TRAIN_FAMILIES.items():
        cfg = get_arch(arch).reduced()
        pipe = SyntheticTokenPipeline(cfg, 2, 32, seed=1)
        losses = []
        for model, state in _train_pair(cfg, seed=0):
            step = make_train_step(model, cosine_schedule(1e-3, 1, 10))
            ls = []
            for i in range(3):
                state, m = step(state, pipe.get_batch(i))
                ls.append(float(m["loss"]))
            losses.append(ls)
        np.testing.assert_allclose(losses[1], losses[0], atol=TRAIN_TOL, rtol=TRAIN_TOL,
                                   err_msg=f"(m3) {arch}: card losses differ from the CPU's")
        out[family] = {"arch": arch, "card": losses[1], "cpu": losses[0]}

    cfg = get_arch(LM_ARCH).reduced()
    batch = SyntheticTokenPipeline(cfg, 4, 64, seed=3).get_batch(1)
    mb = {}
    for n in (1, 2):
        (_, _), (model, state) = _train_pair(cfg, seed=1)
        _, m = make_train_step(model, cosine_schedule(1e-3, 0, 10), microbatches=n)(state, batch)
        mb[n] = float(m["loss"])
    assert abs(mb[2] - mb[1]) <= 1e-5 * abs(mb[1]), f"(m3) 2 microbatches {mb[2]} vs 1 {mb[1]}"
    out["microbatches 1 / 2"] = [mb[1], mb[2]]
    comp = launch_train.main(["--arch", LM_ARCH, "--steps", "3", "--batch", "4", "--seq", "64",
                              "--compression", "--ckpt-dir", tmp])
    assert comp["device"] == "cuda:0" and math.isfinite(comp["final_loss"])
    out["compression final loss"] = comp["final_loss"]
    return out


def _train_checkpoint(tmp: str) -> dict:
    """(m4): save at step 2 on the card, restore into a fresh state (other
    weights), every leaf bit-identical to the saved one; 2 more steps equal
    to the uninterrupted run's."""
    from repro_torch.config import get_arch
    from repro_torch.models import build_model
    from repro_torch.training import CheckpointManager, SyntheticTokenPipeline, cosine_schedule
    from repro_torch.training import make_train_step, train_state_init

    cfg = get_arch(LM_ARCH).reduced()
    pipe = SyntheticTokenPipeline(cfg, 2, 64, seed=9)

    def run(model, state, lo, hi):
        step = make_train_step(model, cosine_schedule(1e-3, 0, 10), compression=True)
        losses = []
        for i in range(lo, hi):
            state, m = step(state, pipe.get_batch(i))
            losses.append(float(m["loss"]))
        return state, losses

    def fresh(seed):
        model = build_model(cfg, "cuda:0", generator=torch.Generator().manual_seed(seed))
        return model, train_state_init(model, compression=True)

    _, whole = run(*fresh(5), 0, 4)
    model, state = fresh(5)
    state, first = run(model, state, 0, 2)
    mgr = CheckpointManager(Path(tmp) / "m4")
    mgr.save(2, state)
    saved = {k: v.detach().clone() for k, v in _named(state)}
    other, template = fresh(77)
    restored, step, _ = mgr.restore(template)
    assert step == 2
    named = _named(restored)
    assert [k for k, _ in named] == list(saved)
    for k, v in named:
        assert v.device.type == "cuda" and v.dtype == saved[k].dtype and torch.equal(v, saved[k]), \
            f"(m4) restored leaf {k} differs from the saved one"
    _, rest = run(other, restored, 2, 4)
    np.testing.assert_allclose(first + rest, whole, atol=TRAIN_TOL, rtol=TRAIN_TOL,
                               err_msg="(m4) resumed run differs from the uninterrupted one")
    return {"leaves": len(named), "uninterrupted": whole, "resumed": first + rest}


def _train_deid_twin() -> dict:
    """(m5): examples/deid_to_training_torch.py on the card (scrub and
    phi_detect launch counts read around it) against its device="cpu" run."""
    import importlib.util

    from repro_torch.kernels import LAUNCHES, reset_launches

    spec = importlib.util.spec_from_file_location("deid_to_training_torch",
                                                  ROOT / "examples" / "deid_to_training_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    reset_launches()
    t0 = time.perf_counter()
    card = twin.main(["--device", "cuda:0"])
    wall = time.perf_counter() - t0
    launched = dict(LAUNCHES)
    for k in ("scrub", "phi_detect"):
        assert launched[k] > 0, f"(m5) kernel {k} never launched on the de-id -> training path"
    cpu = twin.main(["--device", "cpu"])
    assert card["flagged"] == cpu["flagged"] == 0
    assert len(card["delivered"]) == len(cpu["delivered"]) == 12
    for a, b in zip(card["delivered"], cpu["delivered"]):
        assert np.array_equal(a.pixels, b.pixels), "(m5) delivered pixels differ from the CPU run's"
    np.testing.assert_allclose(card["losses"], cpu["losses"], atol=TRAIN_TOL, rtol=TRAIN_TOL,
                               err_msg="(m5) losses differ from the CPU run's")
    return {"launches": launched, "wall_s": wall, "losses": card["losses"], "cpu_losses": cpu["losses"]}


def run_train_path() -> dict:
    """Path (m), training: (m1) qwen2-0.5b at full width through the
    launcher on the card; (m2) f32 card against CPU at full width, 4 layers;
    (m3) every family reduced, card against CPU, microbatches, compression;
    (m4) a checkpoint on the card; (m5) the de-id -> training twin, whose
    scrub and phi_detect launches are read around it. (m1)-(m4) launch
    none of the port's kernels (plain PyTorch, as the reference's training
    is plain jnp): their launch counts must not move."""
    from repro_torch.kernels import LAUNCHES

    t0 = time.perf_counter()
    before = dict(LAUNCHES)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        full = _train_full_width_bf16(tmp)
        log(f"training (m1), {full['arch']} full width bf16 on the card: {json.dumps(full)}")
        f32 = _train_full_width_f32()
        log(f"training (m2), {LM_ARCH} full width f32 (4 layers) card against CPU (1e-4 relative): "
            f"{json.dumps(f32)}")
        fam = _train_reduced_families(tmp)
        log(f"training (m3), reduced families card against CPU (losses 1e-4): {json.dumps(fam)}")
        ckpt = _train_checkpoint(tmp)
        log(f"training (m4), checkpoint on the card: {json.dumps(ckpt)}")
    assert dict(LAUNCHES) == before, f"(m1)-(m4) launched port kernels: {before} -> {dict(LAUNCHES)}"
    twin = _train_deid_twin()
    log(f"training (m5), de-id -> training twin, card against CPU: {json.dumps(twin)}")
    log(f"training (m): {time.perf_counter() - t0:.1f} s")
    return {"bf16": full, "f32": f32, "families": fam, "checkpoint": ckpt, "deid": twin}


# ------------------------------------------- phase 3: LM serving on a mesh (n)
# path (n): the LM serving path over a mesh of cards, one NCCL rank a card,
# spawned by the script. (n1) on every host: qwen2-0.5b at full width in bf16
# on (data 1, model every card), its weights drawn shard by shard from seed 0
# on the ranks, serving (l)'s 8 requests; the f32 model (seed 1) against the
# same weights gathered unsharded on cuda:0. With four cards or more, on
# (data 1, model 4): (n2) qwen1.5-110b at full width cut to 2 layers in f32
# against the same weights gathered on rank 0; (n3) qwen1.5-110b at full
# width and depth (80 layers) in bf16, timed. The model is never shrunk to fit
# fewer cards.
SHARDED_ARCH = "qwen1.5-110b"
SHARDED_CARDS = 4
SHARDED_PARITY_LAYERS = 2
SHARDED_PARITY_STEPS = 4
SHARDED_TIMEOUT_S = 900


def _lm_requests(cfg):
    """(l)'s 8 requests: prompts of 64-512 tokens from numpy seed 0."""
    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT_RANGE[0], LM_PROMPT_RANGE[1] + 1, LM_REQUESTS)
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]


def _padded(prompts):
    P = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), P), np.int64)
    for i, prompt in enumerate(prompts):
        toks[i, P - len(prompt):] = prompt
    return toks


def _mesh_model(cfg, mesh, seed: int):
    """``cfg`` placed on ``mesh`` by ``param_shardings`` (fsdp off), each
    rank drawing only its own shard of each leaf from ``seed``."""
    from repro_torch.launch.shardings import param_shardings, place_model
    from repro_torch.models import build_model

    meta = build_model(cfg, "meta")
    return place_model(meta, param_shardings(meta, mesh, fsdp=False), seed=seed)


def _mesh_rules(mesh, cfg, B: int, S: int):
    from repro_torch.config import ShapeConfig
    from repro_torch.launch.act_sharding import activation_sharding
    from repro_torch.launch.shardings import activation_rules

    return activation_sharding(activation_rules(mesh, ShapeConfig("serve", S, B, "decode"), cfg))


def _mesh_step_comms(model, toks) -> dict:
    """One decode step after a prefill of ``toks``, under ``CommDebugMode``
    and ``CollectiveLog``: collective counts and bytes, and the parameters
    whose shards were all-gathered (must be none)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.shardings import CollectiveLog

    logits, cache = model.prefill({"tokens": toks})
    P = toks.shape[1]
    cache = model.grow_cache(cache, P, P + 1)
    nxt = logits.full_tensor().argmax(-1)
    log_ = CollectiveLog()
    torch.cuda.synchronize()
    with CommDebugMode() as comm, log_:
        model.decode_step(nxt, cache, P)
    torch.cuda.synchronize()
    return {"comm_debug_counts": {str(k): v for k, v in comm.get_comm_counts().items()},
            "counts": log_.counts(), "collectives": len(log_.calls), "bytes": log_.bytes(),
            "gathered_params": log_.gathered_params(model)}


def _mesh_parity(placed, full, toks, steps: int) -> dict:
    """Prefill + ``steps`` greedy decode steps of ``toks`` on the placed model
    (every rank) and on ``full`` (rank 0 only; None elsewhere), fed the
    placed model's greedy tokens: f32 logits within LM_FULL_TOL, tokens
    equal, checked on rank 0."""
    P = toks.shape[1]
    got, cache = placed.prefill({"tokens": toks})
    cache = placed.grow_cache(cache, P, P + steps)
    want = ref_cache = None
    if full is not None:
        want, ref_cache = full.prefill({"tokens": toks})
        ref_cache = full.grow_cache(ref_cache, P, P + steps)
    errs, toks_out = [], []
    for step in range(steps + 1):
        g = got.full_tensor().float().cpu().numpy()
        tok = g.argmax(-1)
        if full is not None:
            w = want.float().cpu().numpy()
            np.testing.assert_allclose(g, w, **LM_FULL_TOL, err_msg=f"sharded f32, step {step}")
            assert np.array_equal(tok, w.argmax(-1)), f"sharded greedy tokens differ at step {step}"
            errs.append(float(np.abs(g - w).max()))
        toks_out.append(tok.tolist())
        if step < steps:
            got, cache = placed.decode_step(tok, cache, P + step)
            if full is not None:
                want, ref_cache = full.decode_step(tok, ref_cache, P + step)
    return {"max_abs_err": errs, "tokens": toks_out}


def _mesh_timed_serve(model, prompts, max_new) -> dict:
    """``_lm_timed_serve`` on a placed model, each rank timing its own steps
    between ``torch.cuda.synchronize()`` calls (the steps' collectives keep
    the ranks in step)."""
    import torch.distributed as dist

    dist.barrier()
    return _lm_timed_serve(model, prompts, max_new)


def _sharded_small(rank: int, world: int) -> dict:
    """(n1): qwen2-0.5b on (data 1, model ``world``)."""
    import gc

    from repro_torch.config import get_arch
    from repro_torch.launch.mesh import make_mesh, mesh_info
    from repro_torch.launch.shardings import gather_model

    mesh = make_mesh((1, world), ("data", "model"))
    cfg = get_arch(LM_ARCH)
    prompts = _lm_requests(cfg)
    out = {"mesh": mesh_info(mesh)}
    t0 = time.perf_counter()
    model = _mesh_model(cfg, mesh, 0)
    torch.cuda.synchronize()
    out["place_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in model.parameters())
    assert out["params"] == cfg.param_count()
    with _mesh_rules(mesh, cfg, LM_REQUESTS, max(len(p) for p in prompts)):
        _mesh_timed_serve(model, prompts, 4)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        run = _mesh_timed_serve(model, prompts, LM_MAX_NEW)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        assert all(len(t) == LM_MAX_NEW and all(0 <= x < cfg.vocab_size for x in t) for t in run["tokens"])
        out.update(prefill_ms=run["prefill"][0] * 1e3,
                   decode_ms_per_step=statistics.median(run["decode"]) * 1e3,
                   decode_ms_min=min(run["decode"]) * 1e3, decode_ms_max=max(run["decode"]) * 1e3,
                   serve_wall_s=run["wall_s"], new_tokens=sum(len(t) for t in run["tokens"]),
                   tokens_first=run["tokens"][0][:8])
        out["tokens_per_s"] = out["new_tokens"] / out["serve_wall_s"]
        out["decode_step_comms"] = _mesh_step_comms(model, _padded(prompts))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # f32: the same architecture, its shards drawn from seed 1, against the
    # same weights gathered unsharded on cuda:0
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    placed = _mesh_model(cfg32, mesh, 1)
    full = gather_model(placed)
    if rank != 0:
        del full
        full = None
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64))
    with _mesh_rules(mesh, cfg32, 2, 64):
        out["f32"] = _mesh_parity(placed, full, toks, SHARDED_PARITY_STEPS)
    return out


def _sharded_large(rank: int, world: int) -> dict:
    """(n2) and (n3): qwen1.5-110b on (data 1, model 4)."""
    import gc

    import torch.distributed as dist

    from repro_torch.config import get_arch
    from repro_torch.launch.mesh import make_mesh, mesh_info
    from repro_torch.launch.shardings import gather_model

    mesh = make_mesh((1, world), ("data", "model"))
    cfg = get_arch(SHARDED_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size) == \
        (80, 8192, 64, 8, 49152, 152064)
    prompts = _lm_requests(cfg)
    toks = _padded(prompts)
    B, P = toks.shape
    out = {"mesh": mesh_info(mesh)}

    # (n2) parity: full width, 2 layers, f32 activations (the spec's bf16
    # weights), against the same weights gathered on rank 0
    cfg2 = dataclasses.replace(cfg, n_layers=SHARDED_PARITY_LAYERS, dtype="float32")
    t0 = time.perf_counter()
    placed = _mesh_model(cfg2, mesh, 0)
    full = gather_model(placed)
    if rank != 0:
        del full
        full = None
    out["parity_params"] = sum(p.numel() for p in placed.parameters())
    out["parity_weight_bytes_unsharded"] = sum(p.numel() * p.element_size() for p in placed.parameters())
    with _mesh_rules(mesh, cfg2, B, P):
        out["parity"] = _mesh_parity(placed, full, toks, SHARDED_PARITY_STEPS)
    out["parity_s"] = time.perf_counter() - t0
    del placed, full
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()

    # (n3) timed: full width and depth, bf16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = _mesh_model(cfg, mesh, 0)
    torch.cuda.synchronize()
    out["place_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == cfg.param_count() == 111_209_914_368
    local_weight_bytes = sum(p.to_local().numel() * p.element_size() for p in model.parameters())
    out.update(params=n_params, weight_bytes_per_card=local_weight_bytes,
               weights_peak_bytes=torch.cuda.max_memory_allocated())
    with _mesh_rules(mesh, cfg, B, P):
        _mesh_timed_serve(model, prompts, 2)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        run = _mesh_timed_serve(model, prompts, LM_MAX_NEW)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        assert all(len(t) == LM_MAX_NEW and all(0 <= x < cfg.vocab_size for x in t) for t in run["tokens"])
        out["decode_step_comms"] = _mesh_step_comms(model, toks)
    # bounds: prefill 2 x params x B x P over 4 cards' dense bf16 rate; a
    # decode step reads each card's weight shards and its share of the K/V
    # up to that step once at the HBM rate
    KV, hd, L = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    kv_bytes = [2 * L * B * (P + s) * KV * hd * 2 // world for s in range(1, LM_MAX_NEW)]
    decode_bound = [(local_weight_bytes + b) / HBM_BYTES_PER_S * 1e3 for b in kv_bytes]
    out.update(B=B, P=P, max_new=LM_MAX_NEW,
               prefill_ms=run["prefill"][0] * 1e3,
               prefill_bound_ms=2 * n_params * B * P / (world * BF16_OPS_PER_S) * 1e3,
               decode_ms_per_step=statistics.median(run["decode"]) * 1e3,
               decode_ms_min=min(run["decode"]) * 1e3, decode_ms_max=max(run["decode"]) * 1e3,
               decode_bound_ms_per_step=statistics.median(decode_bound),
               serve_wall_s=run["wall_s"], new_tokens=sum(len(t) for t in run["tokens"]),
               tokens_first=run["tokens"][0][:8])
    out["tokens_per_s"] = out["new_tokens"] / out["serve_wall_s"]
    out["prefill_pct_of_bound"] = 100 * out["prefill_bound_ms"] / out["prefill_ms"]
    out["decode_pct_of_bound"] = 100 * out["decode_bound_ms_per_step"] / out["decode_ms_per_step"]
    return out


def _sharded_rank(rank: int, world: int, init: str, fn_name: str, out_dir: str) -> None:
    """A spawned rank: one card, an NCCL group met through ``init``; runs
    ``fn_name`` and writes its result (or the error) and peak memory to
    ``out_dir``."""
    import traceback

    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=rank, world_size=world,
                            device_id=torch.device("cuda", rank))
    try:
        result = globals()[fn_name](rank, world)
        # the unsharded twins decode through the decode-attention kernel
        assert not any(v for k, v in LAUNCHES.items() if k != "decode_attn"), \
            f"path (n) launched port kernels: {dict(LAUNCHES)}"
    except Exception:  # recorded for the parent, which fails the path
        result = {"error": traceback.format_exc()}
    result["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(result))
    dist.destroy_process_group()


def _sharded_world(fn_name: str, world: int) -> dict:
    """Spawn ``world`` ranks running ``fn_name``; returns rank 0's result
    with every rank's peak memory. Kills the ranks at SHARDED_TIMEOUT_S."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        ctx = mp.start_processes(_sharded_rank, args=(world, f"{tmp}/init", fn_name, tmp),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.perf_counter() + SHARDED_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                assert time.perf_counter() < deadline, f"{fn_name}: ranks still running at the time limit"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(world)]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"{fn_name} rank {r}:\n{res['error']}"
    out = ranks[0]
    out["max_memory_allocated_by_rank"] = [res["max_memory_allocated"] for res in ranks]
    if "peak_bytes" in out:
        out["peak_bytes_by_rank"] = [res["peak_bytes"] for res in ranks]
    return out


def run_sharded_path() -> dict:
    """Path (n), LM serving on a mesh: (n1) on every card the host has;
    (n2)/(n3) qwen1.5-110b over four cards where there are four. Both parts
    run; the first failure is raised after them."""
    from repro_torch.kernels import LAUNCHES

    before = dict(LAUNCHES)
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    out, failed = {}, []
    try:
        small = _sharded_world("_sharded_small", n)
        comms = small["decode_step_comms"]
        assert comms["gathered_params"] == [], f"(n1) all-gathered parameters: {comms['gathered_params']}"
        log(f"lm on a mesh (n1), {LM_ARCH} full width bf16 over {n} card(s): {json.dumps(small)}")
        log(f"lm on a mesh (n1): card {card_line()}; f32 logits max abs err against the same weights "
            f"unsharded on cuda:0 by step {small['f32']['max_abs_err']} (atol/rtol 1e-3), greedy "
            f"tokens equal; {time.perf_counter() - t0:.1f} s")
        out["n1"] = small
    except AssertionError as exc:
        log(f"lm on a mesh (n1) FAILED: {exc}")
        failed.append(exc)
    if n < SHARDED_CARDS:
        log(f"lm on a mesh (n2)/(n3): {SHARDED_ARCH} at full width needs {SHARDED_CARDS} cards "
            f"(111,209,914,368 params, 222.4 GB in bf16); this host has {n}: not run, and the model "
            f"is not shrunk to fit")
    else:
        t1 = time.perf_counter()
        try:
            large = _sharded_world("_sharded_large", SHARDED_CARDS)
            comms = large["decode_step_comms"]
            assert comms["gathered_params"] == [], f"(n3) all-gathered parameters: {comms['gathered_params']}"
            log(f"lm on a mesh (n2)/(n3), {SHARDED_ARCH} over {SHARDED_CARDS} cards: {json.dumps(large)}")
            log(f"lm on a mesh (n3): card {card_line()}; prefill {large['prefill_ms']:.2f} ms (bound "
                f"{large['prefill_bound_ms']:.3f}), decode {large['decode_ms_per_step']:.2f} ms a step "
                f"(bound {large['decode_bound_ms_per_step']:.3f}), {large['tokens_per_s']:.2f} tokens/s, "
                f"peak by card {large['peak_bytes_by_rank']}, {comms['collectives']} collectives a "
                f"decode step; {time.perf_counter() - t1:.1f} s")
            out["n23"] = large
        except AssertionError as exc:
            log(f"lm on a mesh (n2)/(n3) FAILED: {exc}")
            failed.append(exc)
    if failed:
        raise failed[0]
    assert dict(LAUNCHES) == before, f"path (n) launched port kernels: {before} -> {dict(LAUNCHES)}"
    log(f"lm on a mesh (n): {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------ phase 3: the dry-run (o)
# path (o): the multi-pod dry-run of launch/dryrun.py, every part in a child
# process (a fake process group is global to a process), all started
# together. A trace child runs ``trace_cell`` on a fake world of its own with
# the mesh on cuda (the local tensors are meta: nothing is allocated) and
# prints one JSON line.
_DRYRUN_CHILD = """
import dataclasses, json, sys
sys.path.insert(0, "src")
from repro_torch.config import ShapeConfig, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
job = json.loads(sys.argv[1])
cfg = dataclasses.replace(get_arch(job["arch"]), **job.get("overrides", {}))
dryrun.start_world(job["world"])
mesh = make_mesh(job["mesh"], ("data", "model"), "cuda")
out = dryrun.trace_cell(cfg, ShapeConfig(*job["shape"]), mesh, fsdp=job["fsdp"])
print(json.dumps(out))
"""
DRYRUN_TIMEOUT_S = 600
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", "single"), ("qwen1.5-110b", "decode_32k", "single"),
                ("olmoe-1b-7b", "train_4k", "multi"), ("zamba2-2.7b", "long_500k", "multi"))
DRYRUN_PEAK_TOL = 0.10  # (o1): the traced peak against (m1)'s max_memory_allocated


def _dryrun_jobs(lm: dict) -> dict:
    """(o1)-(o3)'s trace jobs: (m1)'s step, (l)'s decode step at its last
    cache slot, (n3)'s decode step."""
    P = lm["bf16"]["P"]
    jobs = {"o1": {"arch": LM_ARCH, "shape": ["train", TRAIN_SEQ, TRAIN_BATCH, "train"], "world": 1,
                   "mesh": [1, 1], "fsdp": True},
            "o2": {"arch": LM_ARCH, "shape": ["serve", P + LM_MAX_NEW, LM_REQUESTS, "decode"], "world": 1,
                   "mesh": [1, 1], "fsdp": False}}
    if torch.cuda.device_count() >= SHARDED_CARDS:
        jobs["o3"] = {"arch": SHARDED_ARCH, "shape": ["serve", P + 1, LM_REQUESTS, "decode"],
                      "world": SHARDED_CARDS, "mesh": [1, SHARDED_CARDS], "fsdp": False}
    return jobs


def run_dryrun_path(lm: dict, train: dict, sharded: dict) -> dict:
    """Path (o), the multi-pod dry-run, held against what (l), (m) and (n)
    measured in this run; every part runs in a child process, all at once.
    It launches none of the port's kernels: the launch counts must not move."""
    from repro_torch.config import SHAPES, get_arch
    from repro_torch.kernels import LAUNCHES

    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    procs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dryrun-") as tmp:
        for name, job in _dryrun_jobs(lm).items():
            procs[name] = subprocess.Popen([sys.executable, "-c", _DRYRUN_CHILD, json.dumps(job)],
                                           cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, shape, mesh in DRYRUN_CELLS:
            procs[(arch, shape, mesh)] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                 "--mesh", mesh, "--out", f"{tmp}/{arch}__{shape}__{mesh}.json"],
                cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        results = {}
        try:
            for name, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
                assert proc.returncode == 0, f"dry-run (o) {name}: exit {proc.returncode}\n{stderr[-3000:]}"
                if isinstance(name, tuple):
                    results[name] = json.loads(Path(tmp, "__".join(name) + ".json").read_text())
                else:
                    results[name] = json.loads(stdout.strip().splitlines()[-1])
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
    card = card_line()
    out = {"card": card}

    # (o1): (m1)'s step; the FLOP count behind (m1)'s bound, and with what
    # remat "full" recomputes
    o1, m1 = results["o1"], train["bf16"]
    ratio = o1["peak_bytes_per_device"] / m1["peak_bytes"]
    out["o1"] = {"traced_peak_bytes": o1["peak_bytes_per_device"], "measured_peak_bytes": m1["peak_bytes"],
                 "peak_ratio": ratio, "program_flops": o1["program_flops"], "model_flops": m1["model_flops"],
                 "model_plus_recompute_flops": m1["model_flops"] + m1["recompute_flops"],
                 "flops_ratio": o1["program_flops"] / m1["model_flops"], "program_bytes": o1["program_bytes"],
                 "trace_s": o1["trace_s"]}
    log(f"dry-run (o1), (m1)'s step traced on a world of 1: {json.dumps(out['o1'])}")
    assert abs(ratio - 1) <= DRYRUN_PEAK_TOL, \
        f"(o1) traced peak {o1['peak_bytes_per_device']} against (m1)'s measured {m1['peak_bytes']}"

    # (o2): (l)'s decode step at its last slot; the bytes behind (l)'s
    # decode bound at that slot: every weight and the K/V of every position
    o2, l1 = results["o2"], lm["bf16"]
    cfg = get_arch(LM_ARCH)
    bound_bytes = l1["weight_bytes"] + 2 * cfg.n_layers * LM_REQUESTS * (l1["P"] + LM_MAX_NEW) * \
        cfg.n_kv_heads * cfg.hd * 2
    out["o2"] = {"traced_peak_bytes": o2["peak_bytes_per_device"], "measured_serving_peak_bytes": l1["peak_bytes"],
                 "program_bytes": o2["program_bytes"], "bound_bytes": bound_bytes,
                 "bytes_ratio": o2["program_bytes"] / bound_bytes, "program_flops": o2["program_flops"],
                 "trace_s": o2["trace_s"]}
    log(f"dry-run (o2), (l)'s decode step at cache P + {LM_MAX_NEW} traced: {json.dumps(out['o2'])}")

    # (o3): (n3)'s decode step, its collectives against (n3)'s CollectiveLog
    if "o3" not in results or "n23" not in sharded:
        log(f"dry-run (o3): (n3) needs {SHARDED_CARDS} cards; this host has {torch.cuda.device_count()}: "
            f"not run")
    else:
        o3, n3 = results["o3"], sharded["n23"]
        comms = n3["decode_step_comms"]
        names = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
                 "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
        measured = {names.get(k, k): v for k, v in comms["counts"].items()}
        out["o3"] = {"traced_counts": o3["collective_counts"], "measured_counts": measured,
                     "traced_bytes": sum(o3["collectives"].values()), "measured_bytes": comms["bytes"],
                     "traced_peak_bytes": o3["peak_bytes_per_device"], "measured_peak_bytes": n3["peak_bytes"],
                     "trace_s": o3["trace_s"]}
        log(f"dry-run (o3), (n3)'s decode step on a fake world of {SHARDED_CARDS}: {json.dumps(out['o3'])}")
        assert o3["collective_counts"] == measured and out["o3"]["traced_bytes"] == comms["bytes"], \
            f"(o3) traced collectives differ from (n3)'s: {out['o3']}"

    # (o4): four production cells through the command line
    out["o4"] = {}
    for (arch, shape, mesh) in DRYRUN_CELLS:
        rec = results[(arch, shape, mesh)]
        assert rec["status"] == "ok", f"(o4) {arch} {shape} {mesh}: {rec}"
        row = {"peak_gb": rec["peak_bytes_per_device"] / 1e9, "hbm_gb": hw.HBM_PER_CHIP / 1e9,
               "flops": rec["program_flops"], "bytes": rec["program_bytes"],
               "collective_bytes_intra": rec["roofline"]["collective_bytes_intra"],
               "collective_bytes_cross_pod": rec["roofline"]["collective_bytes_cross_pod"],
               "trace_s": rec["trace_s"]}
        if SHAPES[shape].kind == "train":
            tokens = SHAPES[shape].global_batch * SHAPES[shape].seq_len
            row["flops_over_6nd"] = rec["program_flops"] * rec["n_chips"] / (6 * rec["active_params"] * tokens)
            assert 0.5 < row["flops_over_6nd"] < 3.0, f"(o4) {arch} {shape}: {row}"
        out["o4"][f"{arch} {shape} {mesh}"] = row
    log(f"dry-run (o4), production cells: {json.dumps(out['o4'])}")
    assert dict(LAUNCHES) == before, f"path (o) launched port kernels: {before} -> {dict(LAUNCHES)}"
    log(f"dry-run (o): card {card}; {time.perf_counter() - t0:.1f} s")
    return out


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
    each one's counted window, and (e)'s by shape (``LAUNCH_SHAPES``)."""
    from repro_torch.kernels import LAUNCH_SHAPES, LAUNCHES, reset_launches

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
        launches, shapes = dict(LAUNCHES), Counter(LAUNCH_SHAPES)
        log(f"serving path launches: {json.dumps(launches)}; bitmap by shape "
            f"{json.dumps([list(kv) for kv in shapes.items() if kv[0][0] == 'bitmap'])}")
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
    return {"serving": launches, "ingest": ingest_launches, "shapes": {"serving": shapes}}


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


def launched_at(name, key, studies) -> dict:
    """fused or textdetect timed at a launch its wrapper counted on a path:
    ``key`` is (shape, dtype, detail) as ``LAUNCH_SHAPES`` holds it, the
    detail R (rects a plane; the study of that plane size gives the rects)
    or the tile; the pixels are random, full range."""
    from repro_torch.kernels.fused.ops import fused_scrub_residuals
    from repro_torch.kernels.scrub.ops import pack_rects
    from repro_torch.kernels.textdetect.ops import tile_profiles

    shape, dtype, detail = key
    rng = np.random.default_rng(20)
    np_dtype = np.dtype(dtype)
    images = torch.from_numpy(rng.integers(0, np.iinfo(np_dtype).max + 1, size=shape)
                              .astype(np_dtype)).cuda()
    npx, item = images.numel(), images.element_size()
    what = f"{shape} {dtype}"
    if name == "fused":
        study = next(s for s in studies if s.datasets[0].pixels.shape == shape[1:])
        rects = torch.from_numpy(pack_rects([study_rects(study)] * shape[0], R=detail)).cuda()
        return launched_row(f"{what}, R={detail}, sv=1", key,
                            lambda: fused_scrub_residuals(images, rects, sv=1),
                            npx * (item + 4) + rects.numel() * 4, npx * (8 * detail + 16))
    th, tw = detail
    tiles = shape[0] * -(-shape[1] // th) * -(-shape[2] // tw)
    thresh = float(np.iinfo(np_dtype).max) * 0.6
    return launched_row(f"{what}, tile {detail}", key, lambda: tile_profiles(images, thresh=thresh, tile=detail),
                        npx * item + tiles * (th + tw + 1) * 4, npx * 6)


def launched_floor_ms(name) -> float:
    """One block of fused or textdetect ((1, 1, 16) uint16): the floor of a
    time taken this way."""
    from repro_torch.kernels.fused.ops import fused_scrub_residuals
    from repro_torch.kernels.textdetect.ops import tile_profiles

    one = torch.zeros((1, 1, 16), dtype=torch.uint16, device="cuda")
    if name == "fused":
        one_r = torch.zeros((1, 1, 4), dtype=torch.int32, device="cuda")
        return time_ms(lambda: fused_scrub_residuals(one, one_r, sv=1))
    return time_ms(lambda: tile_profiles(one, thresh=1.0))


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

    rows = check_kernels(us.datasets[0].pixels.shape, study_rects(us))
    rows.update(check_detector_kernels(us.datasets[0].pixels.shape))
    rows.update(check_bitmap_kernel())
    rows.update(check_jls_kernel(us.datasets[0].pixels.shape))
    decode_attn_rows = check_decode_attn()
    pseudo = PseudonymService("IRB-SMOKE", TrustMode.POST_IRB, key=b"s" * 32)

    # the cold de-identification path (no detector); warm-up outside the
    # counted window: CUDA context, kernel loads
    main_jobs = [(ct, True, None), (dx, True, None), (us, True, None), (us, False, None)]
    drive(make_pipeline("kernel"), us, pseudo)
    launches, _, main_shapes = run_path("main", main_jobs, pseudo, MAIN_KERNELS)
    throughput(main_jobs, pseudo)
    split = chunk_split(ct)
    log(f"CT chunk (32,512,512) split: {json.dumps(split)}")

    # the detector path: registry_first on the unknown devices (audited),
    # union on the known ones
    det_jobs = [(uct, True, "registry_first"), (udx, True, "registry_first"),
                (ct, True, "union"), (dx, True, "union"), (us, True, "union")]
    det_launches, det_shapes = run_detector_path(det_jobs, 2, pseudo)
    launches.update({k: v for k, v in det_launches.items() if k in DETECTOR_KERNELS})
    throughput([det_jobs[0], det_jobs[2]], pseudo)
    log(f"unknown-CT chunk (32,320,512) detection beside fused upload: "
        f"{json.dumps(detect_split(uct))}")

    # the kernel-assisted encode (f): the jls and fused kernels under the
    # host Golomb-Rice coder
    encoded = run_encode_path([ct, dx, us])
    launches["jls"] = encoded["launches"]["jls"]

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

    # the scenario suite (i), the fleet simulator (j) and the scrub farm (k)
    run_scenario_path()
    run_fleet_path()
    run_farm_path()

    # launches x (ms - bound): each kernel at each shape its wrapper counted
    # on the path its launches are read from (scrub, phi_detect and jls timed
    # in phase 2, fused, textdetect and bitmap at the counted shapes now),
    # the Rice passes at their timed shape
    by_shape = {"scrub": (main_shapes, {job_label((us, False, None))}),
                "phi_detect": (det_shapes, {"during"}),
                "jls": (encoded["shapes"], {"encode"}),
                "bitmap": (served["shapes"], {"serving"}),
                "fused": (main_shapes, {job_label(job) for job in main_jobs if job[1]}),
                "textdetect": (det_shapes, {job_label(job) for job in det_jobs})}
    for name, (by_job, where) in by_shape.items():
        counted = {label: Counter({k[1:]: v for k, v in shapes.items() if k[0] == name})
                   for label, shapes in by_job.items()}
        assert set(k for k, c in counted.items() if c) <= where, \
            f"{name} launched outside {where}: {json.dumps({k: sum(c.values()) for k, c in counted.items()})}"
        total = sum((counted[label] for label in where), Counter())
        if name in ("fused", "textdetect"):
            rows[name]["launched"] = [launched_at(name, key, (ct, dx, us, uct, udx)) for key in sorted(total)]
            rows[name]["launched_floor_ms"] = launched_floor_ms(name)
        elif name == "bitmap":
            rows[name]["launched"] = [bitmap_launched_at(key) for key in sorted(total)]
        timed = {at["key"]: at for at in rows[name]["launched"]}
        assert set(total) == set(timed), f"{name}: launched at {sorted(total)}, timed at {sorted(timed)}"
        for key, at in timed.items():
            at["launches"] = total[key]
            at["gap_ms"] = at["launches"] * (at["ms"] - at["bound_ms"])
        assert sum(at["launches"] for at in timed.values()) == launches[name]
    for name, row in rows.items():
        if row.get("launched"):
            row["gap_ms"], row["gap_at"] = sum(at["gap_ms"] for at in row["launched"]), "launched shapes"
        else:
            row["gap_ms"], row["gap_at"] = launches[name] * (row["ms"] - row["bound_ms"]), "timed shape"
    log("launches x (ms - bound): " + json.dumps(
        {name: round(row["gap_ms"], 6) for name, row in sorted(rows.items(),
                                                                key=lambda kv: -kv[1]["gap_ms"])}))

    # LM serving (l): qwen2-0.5b at full width, and every family reduced.
    # It runs after every kernel timing: timed after (l) and its
    # torch.profiler traces, textdetect's and bitmap's event times were 3-4x
    # those timed without it, fused's unchanged
    lm = run_lm_path()
    # training (m): qwen2-0.5b at full width, every family reduced, a
    # checkpoint, and the de-id -> training twin (scrub, phi_detect)
    train = run_train_path()
    # LM serving on a mesh (n): every card, and qwen1.5-110b over four
    sharded = run_sharded_path()
    # the multi-pod dry-run (o), held against what (l), (m) and (n) measured
    run_dryrun_path(lm, train, sharded)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "equal": True, **row,
                        "pct_of_bound": 100 * row["bound_ms"] / row["ms"]})
    log(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels, "decode_attn": decode_attn_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
