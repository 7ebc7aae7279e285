"""The decode-attention op (``kernels/decode_attn``) off the card: on CPU
tensors ``decode_attention`` is the plain version bit for bit, the wrapper
refuses what the kernel does not take with its reason, the C entry points
take the arguments the wrapper binds, and the plain version meets a float64
oracle of the reference's formula within the limit that holds the kernel on
the card, where two planted faults miss it by far. The kernel itself is held
against the plain version and the oracle on the card
(``tests/test_torch_gpu.py``, which takes its cases, inputs, oracle and limit
from here).
"""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.decode_attn import ops
from repro_torch.models import attention

SRC = Path(__file__).resolve().parents[1] / "src"

# (B, S, KV, G, hd, dtype, pos, window, scale): qwen2-0.5b's and
# granite-4.0-h-small's decode shapes, the reduced configs' float32 cache at
# hd 32, hd 80 and 256, one and 16 query rows a KV head, a window, pos 0, and
# a cache long enough that the kernel's scores go to its scratch tensor
CASES = {
    "qwen2 pos 2047": (32, 2304, 2, 7, 64, torch.bfloat16, 2047, 0, None),
    "qwen2 pos 2303": (32, 2304, 2, 7, 64, torch.bfloat16, 2303, 0, None),
    "granite": (32, 2304, 8, 4, 128, torch.bfloat16, 2303, 0, 1 / 128),
    "f32 hd 32": (2, 300, 2, 4, 32, torch.float32, 200, 0, None),
    "hd 80": (4, 700, 2, 5, 80, torch.bfloat16, 650, 0, None),
    "hd 256": (2, 512, 2, 8, 256, torch.bfloat16, 511, 0, None),
    "G 1": (3, 500, 4, 1, 64, torch.bfloat16, 499, 0, None),
    "G 16": (2, 400, 2, 16, 128, torch.bfloat16, 399, 0, None),
    "window 64": (4, 1000, 2, 7, 64, torch.bfloat16, 900, 64, None),
    "window 64 f32": (4, 1000, 2, 7, 64, torch.float32, 900, 64, None),
    "pos 0": (2, 128, 2, 7, 64, torch.bfloat16, 0, 0, None),
    "scratch": (1, 40000, 1, 8, 64, torch.bfloat16, 39999, 0, None),
}
# The limit on an output's distance from the plain version or the oracle, a
# share of the largest output of the plain version. bf16: the output is
# rounded to bf16, and two f32 sums that differ in their last bits may round
# one ulp apart (up to 2^-7 of an output); a probability at a bf16 rounding
# boundary may round one ulp (up to 2^-7 of it) apart, moving an output by
# 2^-7 * p * |v| for each such probability, a few a row: 2^-6 in all.
# float32: nothing is rounded to bf16, only the sums' order differs (a few
# ulps of sums bounded by max |v| < 4): 2^-17. A wrong kernel misses by the
# order of the output itself (``planted_faults``).
LIMIT = {torch.bfloat16: 2 ** -6, torch.float32: 2 ** -17}
# how far beyond the limit each planted fault must land
FAULT_MARGIN = 8


def draw(B, S, KV, G, hd, dtype, scale, seed, device="cpu"):
    """q and caches whose scores spread with a standard deviation of 2 at
    every shape and scale: with scores near zero the softmax is near uniform,
    every output is about the mean of V, and a kernel that reads the wrong
    rows lands close to the right answer."""
    g = torch.Generator(device).manual_seed(seed)
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=device).clamp(-3.9, 3.9).to(dtype)
            for _ in range(2))
    q = 2 / (scale * math.sqrt(hd)) * torch.randn(B, KV, G, hd, generator=g, device=device)
    return q.to(dtype), k, v


def oracle(q, k, v, pos, window, scale):
    """The reference's formula in float64: the scores of the query rounded
    after its scale, the row's softmax, the probabilities rounded to the
    cache's type, their sum against V."""
    idx = torch.arange(k.shape[1], device=k.device)
    keep = (idx <= pos) & (idx > pos - window) if window else idx <= pos
    s = torch.einsum("bkgd,bskd->bkgs", (q * scale).to(q.dtype).double(), k.double())
    p = torch.softmax(torch.where(keep, s, -torch.inf), dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p.to(k.dtype).double(), v.double())


def limit(plain: torch.Tensor) -> float:
    return LIMIT[plain.dtype] * plain.float().abs().max().item()


def planted_faults(q, k, v, pos, window, scale) -> dict:
    """What two wrong kernels would return, from the plain version: K read
    from the neighbouring KV head, and the mean of V with the scores ignored.
    Only where they differ from the right answer: more than one position
    attended (and more than one KV head for the first)."""
    lo = max(pos - window + 1, 0) if window else 0
    if pos == lo:
        return {}
    faults = {"mean of V": v[:, lo:pos + 1].float().mean(1)[:, :, None, :].expand(q.shape)}
    if k.shape[2] > 1:
        faults["K of the next head"] = attention._decode_core(q, k.roll(1, dims=2), v, pos, window, scale)
    return {name: f.to(q.dtype) for name, f in faults.items()}


def assert_within_limit(got, plain, want):
    """``got`` within the limit of the plain version's output ``plain`` and
    of the oracle's ``want``, where each planted fault misses by far."""
    tol = limit(plain)
    assert (got.float() - plain.float()).abs().max().item() <= tol
    assert (got.double() - want).abs().max().item() <= tol
    return tol


def _inputs(seed, B=3, S=40, KV=2, G=7, hd=16, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
               for shape in ((B, KV * G, hd), (B, S, KV, hd), (B, S, KV, hd)))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,window,scale", [(7, 0, None), (1, 0, 1 / 128), (4, 5, None), (16, 64, None)])
@pytest.mark.parametrize("tensor_pos", [False, True])
def test_decode_attention_on_cpu_is_the_plain_version_bit_for_bit(dtype, G, window, scale, tensor_pos):
    q, k, v = _inputs(G + window, G=G, dtype=dtype)
    B, S, KV, hd = k.shape
    pos = torch.tensor(29) if tensor_pos else 29
    before = LAUNCHES["decode_attn"]
    got = attention.decode_attention(q, k, v, pos, window=window, scale=scale)
    qg = q.reshape(B, KV, G, hd)
    sc = 1.0 / math.sqrt(hd) if scale is None else scale
    plain = attention._decode_core(qg, k, v, pos, window, sc)
    assert got.dtype == dtype and torch.equal(got, plain.reshape(B, KV * G, hd).to(dtype))
    op = ops.decode_attn(qg, k, v, pos, window=window, scale=sc)
    assert op.dtype == dtype and torch.equal(op, plain.to(dtype))
    assert LAUNCHES["decode_attn"] == before  # the CPU runs no kernel


def _refusal(**kw):
    q, k, v = _inputs(0, B=2, S=24, KV=2, G=3, hd=kw.pop("hd", 32), dtype=kw.pop("dtype", torch.bfloat16))
    args = {"qg": q.reshape(2, 2, 3, -1), "k_cache": k, "v_cache": v, "pos": 5, "window": 0}
    args.update({name: f(args) for name, f in kw.items()})
    return args


@pytest.mark.parametrize("case,error,match", [
    ({"hd": 24}, ValueError, "multiple of 16"),
    ({"hd": 272}, ValueError, "multiple of 16"),
    ({"qg": lambda a: a["qg"].float()}, TypeError, "one type"),
    ({"dtype": torch.float16}, TypeError, "one type"),
    ({"k_cache": lambda a: torch.cat([a["k_cache"]] * 2, dim=-1)[..., :32]}, ValueError, "contiguous"),
    ({"qg": lambda a: a["qg"][:1]}, ValueError, "does not fit"),
    ({"window": lambda a: -1}, ValueError, "window"),
    ({"pos": lambda a: 24}, ValueError, "outside"),
    ({"pos": lambda a: torch.tensor(5, dtype=torch.int32)}, ValueError, "0-d int64"),
    ({}, ValueError, "CUDA device"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error, match):
    with pytest.raises(error, match=match):
        ops._check(**_refusal(**dict(case)))


def _params(src: str, symbol: str) -> list:
    """The kinds of the C entry point's parameters: p(ointer), i(nt), f(loat)."""
    sig = re.search(rf"int {symbol}\((.*?)\)\s*\{{", src, re.S).group(1)
    return ["p" if "*" in a else "f" if a.split()[0] == "float" else "i" for a in sig.split(",")]


@pytest.mark.parametrize("symbol,args", [("decode_attn_plan", ops.PLAN_ARGS),
                                         ("decode_attn_launch", ops.LAUNCH_ARGS)])
def test_entry_points_take_what_the_wrapper_binds(symbol, args):
    assert "decode_attn" in build.SOURCES and (build.CSRC / "decode_attn.cu").exists()
    n_ptrs, n_ints, n_floats = args
    want = ["p"] * n_ptrs + ["i"] * n_ints + ["f"] * n_floats + ["p"]  # the stream last
    assert _params((build.CSRC / "decode_attn.cu").read_text(), symbol) == want


def test_kernel_module_imports_and_runs_on_cpu_without_nvcc(tmp_path):
    code = ("import torch, repro_torch.kernels.decode_attn.ops as o, repro_torch.kernels.build as b;"
            "b.BUILD_DIR = b.Path(r'%s') / 'build';"
            "q, k = torch.ones(1, 1, 1, 16), torch.ones(1, 4, 1, 16);"
            "out = o.decode_attn(q, k, k, 3, window=0, scale=0.25);"
            "assert not b.BUILD_DIR.exists() and torch.equal(out, q), out;"
            "print('ok')" % tmp_path)
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(tmp_path / "none"), PYTHONPATH=str(SRC))
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr


@pytest.mark.parametrize("case", list(CASES))
@torch.no_grad()
def test_plain_version_meets_the_oracle_where_planted_faults_miss(case):
    """The limit that holds the kernel on the card, on the CPU's plain
    version: it meets the float64 oracle within it, and a wrong KV head or
    the mean of V lands ``FAULT_MARGIN`` limits or more away."""
    B, S, KV, G, hd, dtype, pos, window, scale = CASES[case]
    scale = 1 / math.sqrt(hd) if scale is None else scale
    q, k, v = draw(B, S, KV, G, hd, dtype, scale, seed=len(case))
    plain = attention._decode_core(q, k, v, pos, window, scale).to(dtype)
    tol = assert_within_limit(plain, plain, oracle(q, k, v, pos, window, scale))
    faults = planted_faults(q, k, v, pos, window, scale)
    assert len(faults) == (0 if pos == 0 else 1 if KV == 1 else 2)
    for name, wrong in faults.items():
        assert (wrong.float() - plain.float()).abs().max().item() > FAULT_MARGIN * tol, name
