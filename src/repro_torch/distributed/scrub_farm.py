"""Distributed scrub farm: the paper's autoscaled worker pool across cards.

The paper parallelizes de-identification across cloud VMs pulling from a
queue. Here each card of the farm takes one equal shard of an image batch
and runs the scrub kernel (``kernels/scrub``) on it. There is **no**
cross-device communication in the hot path — scrubbing is embarrassingly
parallel, which is why the paper's design scales — so the farm needs no
process group: one host thread launches every shard on its card's current
stream, and copies the shards back only after all of them have launched,
so the cards work at the same time.

Host-side responsibilities (this module):
  * resolution bucketing — studies mix 512x512 CT with 2500x2048 DX; batches
    must be shape-uniform per dispatch (the paper's per-resolution rules have
    the same effect);
  * batch padding to a multiple of the device count, cropped after;
  * writing scrubbed pixels back into the DICOM datasets.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dicom.dataset import DicomDataset
from repro_torch.dicom.devices import Rect
from repro_torch.kernels.scrub.ops import pack_rects, scrub_images


def cuda_devices() -> List[torch.device]:
    """Every CUDA device, ``cuda:0 .. cuda:{count-1}``; raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the scrub farm defaults to every CUDA device but CUDA is not "
            "available; pass devices=[torch.device(\"cpu\"), ...] for the plain "
            "PyTorch versions"
        )
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def bucket_by_resolution(
    datasets: Sequence[DicomDataset],
) -> Dict[Tuple[int, int], List[int]]:
    """Group dataset indices by pixel resolution (H, W)."""
    buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i, ds in enumerate(datasets):
        if ds.pixels is not None:
            buckets[ds.pixels.shape[:2]].append(i)
    return dict(buckets)


def _on(device: torch.device):
    """Make ``device`` current for a launch: a kernel goes to the current
    card, on the stream of its tensors' card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class ScrubFarm:
    """Batched scrubbing, one equal shard of each batch per device."""

    def __init__(self, devices: Sequence[DeviceLike] | None = None) -> None:
        devices = list(devices) if devices is not None else cuda_devices()
        if not devices:
            raise ValueError("a scrub farm needs at least one device")
        self.devices = [resolve_device(d) for d in devices]
        self.n = len(self.devices)

    # ------------------------------------------------------------- core op
    def scrub_batch(self, images: np.ndarray, rect_lists: Sequence[Sequence[Rect]]) -> np.ndarray:
        """images: (N, H, W); rect_lists: ragged per-image rects. Shards the
        batch over the devices, scrubs, returns (N, H, W)."""
        N = images.shape[0]
        rects = pack_rects(rect_lists, R=max(4, max((len(r) for r in rect_lists), default=1)))
        pad = (-N) % self.n
        if pad:
            images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
            rects = np.concatenate([rects, np.zeros((pad,) + rects.shape[1:], rects.dtype)])
        shard = images.shape[0] // self.n
        outs = []
        for k, dev in enumerate(self.devices):
            part = slice(k * shard, (k + 1) * shard)
            with _on(dev):
                imgs = torch.from_numpy(np.ascontiguousarray(images[part])).to(dev)
                outs.append(scrub_images(imgs, torch.from_numpy(rects[part]).to(dev)))
        # every shard is in flight before the first copy back waits on its card
        return np.concatenate([o.cpu().numpy() for o in outs])[:N]

    # ------------------------------------------------------- dataset plane
    def process_datasets(
        self,
        datasets: Sequence[DicomDataset],
        rects_for,
    ) -> Dict[int, List[Rect]]:
        """Scrub a heterogeneous batch of datasets in resolution buckets.

        ``rects_for(ds) -> Optional[tuple[Rect, ...]]`` is typically
        ``ScrubStage.rects_for``. Pixels are modified in place; returns
        {dataset index: applied rects} for manifest recording.
        """
        applied: Dict[int, List[Rect]] = {}
        buckets = bucket_by_resolution(datasets)
        for (H, W), idxs in buckets.items():
            todo: List[int] = []
            rl: List[List[Rect]] = []
            for i in idxs:
                rects = rects_for(datasets[i])
                if rects:
                    todo.append(i)
                    rl.append(list(rects))
                    applied[i] = list(rects)
            if not todo:
                continue
            stack = np.stack([datasets[i].pixels for i in todo])
            out = self.scrub_batch(stack, rl)
            for j, i in enumerate(todo):
                datasets[i].pixels = out[j]
        return applied
