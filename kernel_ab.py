#!/usr/bin/env python3
"""Time this tree's CUDA kernels against another tree's, in turns, in one
process on one card.

    mkdir -p .chipcheck/other
    git archive <commit> src/repro_torch/csrc | tar -x -C .chipcheck/other
    python3 kernel_ab.py .chipcheck/other

``.chipcheck/`` is git-ignored. The other tree's ``csrc/`` is built with
this tree's flags, and both versions are launched through this tree's
wrappers (``kernels.build.sources_from``), so their C entry points must take
the same arguments. The kernels are scrub and phi_detect at the CT chunk
and where the paths launch them, and fused at the CT chunk (it shares
``csrc/rects.cuh`` with scrub). At each shape both versions run on the same
inputs: their outputs must be equal, and each is timed as ``chip_smoke.py``
times a kernel (cold L2, CUDA events, median of 21) in the order other,
this, this, other. Prints one JSON line per shape, the card's name and
power limit, and a last JSON line with every row.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import card_line, log, study_rects, time_ms

CT = (32, 512, 512)
CT_RECTS = [(256, 0, 256, 22), (300, 22, 212, 80)]
AUDIT_SHAPES = ((1, 320, 512), (1, 520, 648))


def cases(rng) -> dict:
    """Per kernel, named as its source ``csrc/<name>.cu``: (label, call)
    pairs; each call runs the kernel's wrapper on inputs made here, on the
    card."""
    from repro_torch.dicom.generator import StudyGenerator
    from repro_torch.kernels.fused.ops import fused_scrub_residuals
    from repro_torch.kernels.phi_detect import cases as phi_cases
    from repro_torch.kernels.phi_detect.ops import edge_density
    from repro_torch.kernels.scrub.ops import pack_rects, scrub_images

    ct = torch.from_numpy(rng.normal(1200, 300, size=CT).clip(0, 4095).astype(np.uint16)).cuda()
    ct_r = torch.from_numpy(pack_rects([CT_RECTS] * CT[0])).cuda()
    us_study = StudyGenerator(seed=7).gen_study("SMOKE-US", modality="US", n_images=32)
    uH, uW = us_study.datasets[0].pixels.shape
    rects = study_rects(us_study)
    R = 1 << max(len(rects) - 1, 0).bit_length()  # the executor's power-of-two bucket
    us = torch.from_numpy(rng.integers(0, 256, size=(32, uH, uW)).astype(np.uint8)).cuda()
    us_r = torch.from_numpy(pack_rects([rects] * 32, R=R)).cuda()
    thresh = 4095 * 0.25
    audit = {shape: torch.from_numpy(phi_cases.planes(rng, np.uint16, shape)[:1]).cuda()
             for shape in AUDIT_SHAPES}
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
        ],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the other tree (holds src/repro_torch/csrc)")
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
            for line in rep["log"].splitlines():
                if "registers" in line:
                    log(f"{tree} {name}: {line.strip()}")

    rows = []
    for kernel, calls in table.items():
        for shape, call in calls:
            with build.sources_from(other):
                want = call()
            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{kernel} at {shape}: this tree's result != the other's")

            def other_ms():
                with build.sources_from(other):
                    return time_ms(call)

            runs = [other_ms(), time_ms(call), time_ms(call), other_ms()]
            row = {"kernel": kernel, "shape": shape, "ms": (runs[1] + runs[2]) / 2,
                   "other_ms": (runs[0] + runs[3]) / 2, "runs": runs, "equal": True}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(card_line())
    print(json.dumps({"ab": rows, "other": str(args.other)}), flush=True)


if __name__ == "__main__":
    main()
