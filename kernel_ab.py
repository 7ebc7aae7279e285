#!/usr/bin/env python3
"""Time this tree's CUDA kernels against another tree's, in turns, in one
process on one card.

    mkdir -p .chipcheck/other
    git archive <commit> src/repro_torch/csrc | tar -x -C .chipcheck/other
    python3 kernel_ab.py .chipcheck/other

``.chipcheck/`` is git-ignored. The other tree's ``csrc/`` is built with
this tree's flags, and both versions are launched through this tree's
wrappers (``kernels.build.sources_from``), so their C entry points must take
the same arguments. The kernels are scrub, phi_detect, fused, textdetect
and jls at the CT chunk and where the paths launch them (fused at the CT,
DX and US chunks of the cold path; textdetect at the unknown-CT,
unknown-DX, DX and US chunks of the detector path; jls at the CT, DX and US
chunks of the encode), and bitmap at the 2^22-row full scan ((5, 131072)
words, the 11 ops of ``kernels/bitmap/cases.py::chain(4)``) and at one
word. At each shape both versions run on the same inputs: their outputs
must be equal, and each is timed as
``chip_smoke.py`` times a kernel (cold L2, CUDA events around the call,
median of 21) in the order other, this, this, other. Logs each tree's
registers and spills a kernel (``nvcc -Xptxas -v``), prints one JSON line
per shape, the card's name and power limit, and a last JSON line with
every row.

With ``--trace DIR`` it then records a ``torch.profiler`` (CUPTI) trace of
textdetect, jls and bitmap, both trees, at each of their shapes above,
textdetect also at one block and over 1-32 images of the CT chunk beside
phi_detect (which reads the same bytes), and keeps the traces in DIR. From
each it prints the kernel's device duration and the device's idle time
before it, since the end of the kernel before (the L2 flush, or the
bitmap wrapper's zeroing of its count) (median of 21, each after an L2
flush), and for the image sweep a least-squares line of duration against
megabytes: its intercept is the kernel's fixed cost, its slope the rate at
which it streams.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import REPS, bucket, card_line, log, study_rects, time_ms

CT = (32, 512, 512)
CT_RECTS = [(256, 0, 256, 22), (300, 22, 212, 80)]
AUDIT_SHAPES = ((1, 320, 512), (1, 520, 648))
# textdetect's launched chunks beside the CT chunk: unknown CT, unknown DX,
# DX (uint16) and US (uint8), tile (32, 128)
TEXT_SHAPES = (((32, 320, 512), np.uint16), ((4, 520, 648), np.uint16),
               ((4, 2500, 2048), np.uint16), ((32, 540, 720), np.uint8))


def cases(rng) -> dict:
    """Per kernel, named as its source ``csrc/<name>.cu``: (label, call)
    pairs; each call runs the kernel's wrapper on inputs made here, on the
    card."""
    from repro_torch.dicom.devices import DeviceKey
    from repro_torch.dicom.generator import StudyGenerator
    from repro_torch.kernels.bitmap.cases import chain
    from repro_torch.kernels.bitmap.ops import combine_bitmaps_launch
    from repro_torch.kernels.fused.ops import fused_scrub_residuals
    from repro_torch.kernels.jls.ops import jls_residuals
    from repro_torch.kernels.phi_detect import cases as phi_cases
    from repro_torch.kernels.phi_detect.ops import edge_density
    from repro_torch.kernels.scrub.ops import pack_rects, scrub_images
    from repro_torch.kernels.textdetect import cases as text_cases
    from repro_torch.kernels.textdetect.ops import tile_profiles

    ct = torch.from_numpy(rng.normal(1200, 300, size=CT).clip(0, 4095).astype(np.uint16)).cuda()
    ct_r = torch.from_numpy(pack_rects([CT_RECTS] * CT[0])).cuda()
    gen = StudyGenerator(seed=7)
    us_study = gen.gen_study("SMOKE-US", modality="US", n_images=32)
    uH, uW = us_study.datasets[0].pixels.shape
    rects = study_rects(us_study)
    R = bucket(len(rects))
    us = torch.from_numpy(rng.integers(0, 256, size=(32, uH, uW)).astype(np.uint8)).cuda()
    us_r = torch.from_numpy(pack_rects([rects] * 32, R=R)).cuda()
    dx_study = gen.gen_study("SMOKE-DX", device=DeviceKey("DX", "GE", "Definium", 2500, 2048),
                             n_images=4)
    dx_rects = study_rects(dx_study)
    dx = torch.from_numpy(rng.integers(0, 65536, size=(4, 2500, 2048)).astype(np.uint16)).cuda()
    dx_r = torch.from_numpy(pack_rects([dx_rects] * 4, R=bucket(len(dx_rects)))).cuda()
    text = {}
    for shape, dtype in ((CT, np.uint16),) + TEXT_SHAPES:
        top = text_cases.top(dtype)
        text[shape] = (torch.from_numpy(text_cases.planes(rng, dtype, shape)[:shape[0]]).cuda(),
                       top * 0.6)
    thresh = 4095 * 0.25
    audit = {shape: torch.from_numpy(phi_cases.planes(rng, np.uint16, shape)[:1]).cuda()
             for shape in AUDIT_SHAPES}
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(5, 1 << 17), dtype=np.int64)
                             .astype(np.int32)).cuda()
    one_word = words[:2, :1].contiguous()
    return {
        "scrub": [
            (f"{CT} uint16, R=2", lambda: scrub_images(ct, ct_r)),
            (f"(32, {uH}, {uW}) uint8, R={R}", lambda: scrub_images(us, us_r)),
        ],
        "phi_detect": [
            (f"{CT} uint16, tile (32,128)", lambda: edge_density(ct, thresh=thresh)),
            *[(f"{shape} uint16, tile (32,128)", lambda img=img: edge_density(img, thresh=thresh))
              for shape, img in audit.items()],
        ],
        "fused": [
            (f"{CT} uint16, R=2, sv=1", lambda: fused_scrub_residuals(ct, ct_r, sv=1)),
            (f"{tuple(dx.shape)} uint16, R={dx_r.shape[1]}, sv=1",
             lambda: fused_scrub_residuals(dx, dx_r, sv=1)),
            (f"(32, {uH}, {uW}) uint8, R={R}, sv=1", lambda: fused_scrub_residuals(us, us_r, sv=1)),
        ],
        "textdetect": [
            (f"{shape} {str(img.dtype).removeprefix('torch.')}, tile (32,128)",
             lambda img=img, t=t: tile_profiles(img, thresh=t))
            for shape, (img, t) in text.items()
        ],
        "jls": [
            (f"{tuple(img.shape)} {str(img.dtype).removeprefix('torch.')}, sv=1",
             lambda img=img: jls_residuals(img, sv=1))
            for img in (ct, dx, us)
        ],
        "bitmap": [
            ("(5, 131072) int32 words (n=2^22), 11 ops",
             lambda: combine_bitmaps_launch(words, chain(4))),
            ("(2, 1) int32 words, one word, 3 ops",
             lambda: combine_bitmaps_launch(one_word, chain(1))),
        ],
    }


def same(a, b) -> bool:
    """Equal results: one tensor each, or tuples of them (textdetect)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(torch.equal, a, b))
    return torch.equal(a, b)


# the CUDA function of each kernel, as the trace names it
FUNCTION = {"bitmap": "combine_kernel"}


def device_us(call, kernel: str, path: Path, reps: int = REPS) -> tuple[float, float]:
    """Median device duration (us) of the kernel's CUDA function (``FUNCTION``,
    else ``<kernel>_kernel``) over ``reps`` calls of ``call``, each after an
    L2 flush, and the median idle time of the card between the end of the
    kernel before it (the flush, or what the call launched first) and its
    start, from a ``torch.profiler`` trace kept at ``path``."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    runs = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    durs, gaps = [], []
    function = FUNCTION.get(kernel, f"{kernel}_kernel")
    for prev, e in zip(runs, runs[1:]):
        if function in e["name"]:
            durs.append(e["dur"])
            gaps.append(e["ts"] - (prev["ts"] + prev["dur"]))
    if len(durs) != reps:
        raise RuntimeError(f"{path}: {len(durs)} {function} launches traced, not {reps}")
    return statistics.median(durs), statistics.median(gaps)


def trace(table: dict, other: Path, out: Path, rng) -> list[dict]:
    """textdetect's, jls's and bitmap's device durations from traces (module
    docstring)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.phi_detect.ops import edge_density
    from repro_torch.kernels.textdetect import cases as text_cases
    from repro_torch.kernels.textdetect.ops import tile_profiles

    out.mkdir(parents=True, exist_ok=True)
    ct = torch.from_numpy(text_cases.planes(rng, np.uint16, CT)[:CT[0]]).cuda()
    t = text_cases.top(np.uint16) * 0.6
    one = ct[:1, :1, :16].contiguous()  # one block
    calls = [(kernel, label, call) for kernel in ("textdetect", "jls", "bitmap")
             for label, call in table[kernel]]
    calls.append(("textdetect", "(1, 1, 16) uint16, one block", lambda: tile_profiles(one, thresh=t)))
    for n in (1, 2, 4, 8, 16, 32):
        img = ct[:n]
        for kernel, fn in (("textdetect", tile_profiles), ("phi_detect", edge_density)):
            calls.append((kernel, f"sweep ({n}, 512, 512) uint16",
                          lambda img=img, fn=fn: fn(img, thresh=t)))
    rows = []
    for tree in ("this", "other"):
        for i, (kernel, label, call) in enumerate(calls):
            if tree == "other" and label.startswith("sweep"):
                continue
            with build.sources_from(other) if tree == "other" else contextlib.nullcontext():
                dur, gap = device_us(call, kernel, out / f"{tree}_{kernel}_{i}.json")
            row = {"trace": kernel, "tree": tree, "shape": label, "kernel_us": dur, "idle_us": gap}
            rows.append(row)
            print(json.dumps(row), flush=True)
    fits = []
    for kernel in ("textdetect", "phi_detect"):
        pts = [(int(r["shape"].split("(")[1].split(",")[0]) * CT[1] * CT[2] * 2 / 1e6, r["kernel_us"])
               for r in rows if r["trace"] == kernel and r["shape"].startswith("sweep")]
        slope, intercept = np.polyfit([p[0] for p in pts], [p[1] for p in pts], 1)
        fits.append({"fit": kernel, "fixed_us": float(intercept), "us_per_MB": float(slope),
                     "GB_per_s": float(1e3 / slope)})
        print(json.dumps(fits[-1]), flush=True)
    return rows + fits


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the other tree (holds src/repro_torch/csrc)")
    ap.add_argument("--trace", type=Path, metavar="DIR",
                    help="also trace textdetect, jls and bitmap with torch.profiler and keep the "
                         "traces in DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: CUDA is not available; this script runs only on a card")
    from repro_torch.kernels import build

    other = (args.other / "src/repro_torch/csrc").resolve()
    if not other.is_dir():
        sys.exit(f"kernel_ab: no {other}")
    table = cases(np.random.default_rng(15))
    report = {"this": build.build_all(table)}
    with build.sources_from(other):
        report["other"] = build.build_all(table)
    for tree, built in report.items():
        for name, rep in built.items():
            entry = ""
            for line in rep["log"].splitlines():
                if "Compiling entry function" in line:
                    entry = line.split("'")[1]
                elif "registers" in line or "spill" in line:
                    log(f"{tree} {name} {entry}: {line.strip()}")

    rows = []
    for kernel, calls in table.items():
        for shape, call in calls:
            with build.sources_from(other):
                want = call()
            got = call()
            torch.cuda.synchronize()
            if not same(got, want):
                raise AssertionError(f"{kernel} at {shape}: this tree's result != the other's")

            def other_ms():
                with build.sources_from(other):
                    return time_ms(call)

            runs = [other_ms(), time_ms(call), time_ms(call), other_ms()]
            row = {"kernel": kernel, "shape": shape, "ms": (runs[1] + runs[2]) / 2,
                   "other_ms": (runs[0] + runs[3]) / 2, "runs": runs, "equal": True}
            rows.append(row)
            print(json.dumps(row), flush=True)
    traced = trace(table, other, args.trace, np.random.default_rng(16)) if args.trace else []
    print(card_line())
    print(json.dumps({"ab": rows, "trace": traced, "other": str(args.other)}), flush=True)


if __name__ == "__main__":
    main()
