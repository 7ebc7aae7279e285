"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  scrub   - batched PHI rectangle blanking (``csrc/scrub.cu``)
  fused   - single-pass scrub + JPEG-Lossless residuals (``csrc/fused.cu``)
  jls     - JPEG-Lossless predictor residuals (``csrc/jls.cu``) and the
            Golomb-Rice plan pre-pass: zigzag + row sums, code lengths +
            remainders (``csrc/entropy.cu``)
  textdetect - per-tile glyph-hit profiles and max runs of the burned-in-PHI
            detector (``csrc/textdetect.cu``)
  phi_detect - per-tile strong-edge density of the post-scrub audit
            (``csrc/phi_detect.cu``)
  bitmap  - packed-bitmap predicate combine + popcount of the catalog's
            query engine (``csrc/bitmap.cu``)

A public op takes torch tensors: on a CUDA tensor it launches its kernel
(or raises), on a CPU tensor it runs the plain PyTorch version. Each launch
adds one to its entry of :data:`LAUNCHES`, so a run can show which kernels
the main path went through.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {
    "fused": 0, "rice_prepass": 0, "rice_len_rem": 0, "scrub": 0, "textdetect": 0, "phi_detect": 0,
    "bitmap": 0, "jls": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


__all__ = ["LAUNCHES", "reset_launches"]
