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
  decode_attn - one new token's attention against the bf16 or float32 K/V
            cache, read in place (``csrc/decode_attn.cu``); replaces no TPU
            kernel: its plain version is ``models/attention.py::_decode_core``

A public op takes torch tensors: on a CUDA tensor it launches its kernel
(or raises), on a CPU tensor it runs the plain PyTorch version. Each launch
adds one to its entry of :data:`LAUNCHES`, so a run can show which kernels
the main path went through, and to :data:`LAUNCH_SHAPES` under its kernel,
shape, dtype and launch detail, so it can show at which shapes.
"""
from collections import Counter
from typing import Dict, Hashable

LAUNCHES: Dict[str, int] = {
    "fused": 0, "rice_prepass": 0, "rice_len_rem": 0, "scrub": 0, "textdetect": 0, "phi_detect": 0,
    "bitmap": 0, "jls": 0, "decode_attn": 0,
}


# (kernel, shape, dtype, detail) -> launches; detail is what else sets the
# launch's work (rects per image, tile, selection value), or None
LAUNCH_SHAPES: Counter = Counter()


def count_launch(name: str, t, detail: Hashable = None) -> None:
    """Count one launch of kernel ``name`` on tensor ``t``: called by its
    wrapper where it launches the kernel, and nowhere else."""
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, tuple(t.shape), str(t.dtype).removeprefix("torch."), detail)] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()


__all__ = ["LAUNCHES", "LAUNCH_SHAPES", "count_launch", "reset_launches"]
