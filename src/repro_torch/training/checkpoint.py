"""Checkpoint/restart for the training plane, in the reference's layout.

Chunked-npz layout, crash-safe by construction:

  step_000123/
    meta.json        # step, tree structure, keys, dtypes, extra
    arrays.npz       # flat leaves keyed by tree path
  LATEST             # atomic pointer file, written last

Writes go to a temp dir + fsync + atomic rename; the LATEST pointer flips
only after the payload is durable, so a crash mid-write never corrupts the
restore path (the previous checkpoint stays live). keep_n retention.

Leaf keys are the JAX package's (``jax.tree.flatten_with_path``): a
NamedTuple field is ``.name`` and a dict key is the key, joined by ``/``
(``.params/embed/tok``, ``.opt/.step``,
``.comp/layers/attn/bq/.residual``). bf16 leaves are stored as their raw
``uint16`` bits with ``bfloat16`` named in ``meta.json``. So a checkpoint
written by either package restores in the other.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

_NPZ_DTYPES = {"float32", "float64", "int32", "int64", "uint8", "uint16", "uint32", "int8", "int16",
               "bool"}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """{key: leaf} of a tree of NamedTuples and dicts, in the JAX package's
    key spelling and leaf order. None is an empty subtree."""
    if tree is None:
        return {}
    if _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    else:
        return {"/".join(prefix): tree}
    out: Dict[str, Any] = {}
    for name, val in items:
        out.update(flatten_with_paths(val, prefix + (name,)))
    return out


def unflatten_with_paths(tree: Any, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(unflatten_with_paths(getattr(tree, f), leaves, prefix + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: unflatten_with_paths(tree[k], leaves, prefix + (str(k),)) for k in tree}
    return leaves["/".join(prefix)]


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy()  # npz cannot hold bf16: raw bits
        return t.numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep_n: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, extra: Optional[dict] = None) -> Path:
        arrays, dtypes = {}, {}
        for k, v in flatten_with_paths(state).items():
            dtypes[k] = _dtype_name(v)
            arr = _to_numpy(v)
            if arr.dtype.name not in _NPZ_DTYPES:  # e.g. ml_dtypes' bfloat16 in a numpy tree
                arr = arr.view(np.uint16 if arr.dtype.itemsize == 2 else np.uint8)
            arrays[k] = arr
        meta = {
            "step": int(step),
            "treedef": type(state).__name__,
            "keys": sorted(arrays.keys()),
            "dtypes": dtypes,
            "extra": extra or {},
        }

        final = self.dir / f"step_{step:08d}"
        tmp = Path(tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=self.dir))
        try:
            np.savez(tmp / "arrays.npz", **arrays)
            (tmp / "meta.json").write_text(json.dumps(meta))
            for f in tmp.iterdir():  # fsync payload before the rename
                with open(f, "rb") as fh:
                    os.fsync(fh.fileno())
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._write_latest(final.name)
        self._gc()
        return final

    def _write_latest(self, name: str) -> None:
        tmp = self.dir / ".LATEST.tmp"
        tmp.write_text(name)
        with open(tmp) as fh:
            os.fsync(fh.fileno())
        os.replace(tmp, self.dir / "LATEST")

    def _gc(self) -> None:
        ckpts = sorted(p for p in self.dir.iterdir() if p.name.startswith("step_"))
        for old in ckpts[: -self.keep_n]:
            shutil.rmtree(old, ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "LATEST"
        if not ptr.exists():
            return None
        name = ptr.read_text().strip()
        if not (self.dir / name / "meta.json").exists():
            return None
        return int(name.split("_")[1])

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[Any, int, dict]:
        """Restore into the structure of ``template`` (shapes and dtypes
        checked, leaves placed on the template leaf's device). A leaf that is
        an ``nn.Parameter`` (a model's weights) is written in place and
        returned; every other leaf is a new tensor."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / "arrays.npz") as npz:
            arrays = {k: npz[k] for k in npz.files}
        saved_dtypes = meta.get("dtypes", {})
        restored = {}
        for key, tmpl in flatten_with_paths(template).items():
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = arrays[key]
            t = tmpl if isinstance(tmpl, torch.Tensor) else torch.as_tensor(np.asarray(tmpl))
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs template {tuple(t.shape)}")
            saved = saved_dtypes.get(key, arr.dtype.name)
            want = _dtype_name(t)
            if arr.dtype.name != saved:
                # raw-bits roundtrip (bfloat16 stored as uint16): the saved
                # dtype must match the template's for exact restore
                if saved != want:
                    raise ValueError(f"dtype mismatch for {key}: ckpt {saved} vs template {t.dtype}")
                val = torch.from_numpy(np.array(arr)).view(t.dtype)
            else:
                val = torch.from_numpy(np.array(arr)).to(t.dtype)
            restored[key] = val.to(t.device)
        for key, tmpl in flatten_with_paths(template).items():
            if isinstance(tmpl, nn.Parameter):
                with torch.no_grad():
                    tmpl.copy_(restored[key])
                restored[key] = tmpl
        return unflatten_with_paths(template, restored), meta["step"], meta.get("extra", {})
