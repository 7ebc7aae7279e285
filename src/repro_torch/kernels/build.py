"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`. A library
is built at first use, or all at once with :func:`build_all` (one ``nvcc``
per source, started together), into ``src/repro_torch/_build/`` under a name
keyed by the hash of its sources and flags, so an edited source rebuilds and
an unchanged one is reused. Nothing here runs at import time.
:func:`sources_from` points the wrappers at another tree's ``csrc/`` for
the length of a block, to time two versions of a kernel in turns.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("scrub", "fused", "entropy", "textdetect", "phi_detect", "bitmap", "jls", "decode_attn")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[tuple, ctypes.CDLL] = {}
_lock = threading.Lock()
_csrc = CSRC  # the sources the wrappers build and launch


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is installed")


@contextlib.contextmanager
def sources_from(csrc: Path):
    """Inside the block the wrappers build and launch the kernels of
    another tree's ``csrc/`` (an earlier commit's, unpacked with ``git
    archive``) through their own code, so two versions of a kernel can be
    timed in turns in one process. Their C entry points must take the same
    arguments as this tree's."""
    global _csrc
    with _lock:
        prev, _csrc = _csrc, Path(csrc).resolve()
    try:
        yield
    finally:
        with _lock:
            _csrc = prev


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in [_csrc / f"{name}.cu", *sorted(_csrc.glob("*.cuh"))]:
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every missing library, all ``nvcc`` runs in parallel.

    Returns per source: wall seconds of its build (0 when it was already
    built) and the compiler's resource report (``-Xptxas -v``). Raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(_csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    report = {name: {"seconds": 0.0, "log": ""} for name in names}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        key = (_csrc, name)
        lib = _libs.get(key)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build_all([name])
            lib = _libs[key] = ctypes.CDLL(str(out))
        return lib


def bind(name: str, symbol: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """C entry point ``symbol`` of library ``name`` with its argument types
    set: ``n_ptrs`` pointers, ``n_ints`` ints, ``n_floats`` floats (32-bit:
    a threshold compared in float32 must reach the kernel as one), then the
    stream pointer."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
