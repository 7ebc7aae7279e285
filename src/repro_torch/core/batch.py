"""Shape-bucketed, pipelined batch executor for the de-id hot path.

A study is hundreds of same-shape slices, so the executor batches them the
way the card wants:

* **bucket** — group instances by (H, W, dtype, rect-count bucket). Studies
  mix 512x512 CT with 2500x2048 DX; dispatches must be shape-uniform.
* **pad once** — each chunk pads its batch dim to a power of two (capped at
  ``max_batch``, itself normalized to a power of two) and its rect dim to
  the bucket's power-of-two, so the set of padded shapes stays small and
  closed (the same rule as the JAX package, whose jit cache needs it).
* **dispatch** — the padded chunk is staged in pinned host memory and copied
  to the card asynchronously; then one fused scrub+residual kernel
  (``kernels/fused``) and the Golomb-Rice zigzag/row-sum pre-pass
  (``kernels/jls/entropy``) are queued on the current stream, or the scrub
  kernel alone when recompression is off.
* **pipeline** — ``run`` is split into submit/collect with up to
  ``pipeline_depth`` chunks in flight: chunk N+1's copies and kernels are
  queued before the host tail of chunk N is drained. Collect syncs on the
  row sums, derives each instance's Rice k on the host from their exact
  int64 total, queues the code-length/remainder kernel, copies ``u``,
  ``lens`` and ``rem`` back and leaves the host only the unary splice
  (``codec.rice_pack``).
* **host tail** — per-instance pack/encode jobs fan out across a small
  thread pool (numpy releases the GIL); jobs are pure functions of host
  numpy arrays (never CUDA tensors) and are drained in submission order, so
  payload bytes are identical for any pool size, including the inline
  ``host_workers=0`` mode.
* **detect** — :meth:`BatchedDeidExecutor.detect_row_hits` runs the
  burned-in-PHI detector's profile pass over (H, W, dtype, threshold)
  buckets under the same padding rule: one textdetect kernel per chunk and
  a row sum on the card, (n, H) int32 row hits back to the host. It is
  synchronous, ahead of ``run``, and uploads the planes it scans once more
  than ``run`` does.

The executor owns dispatch statistics and a lazily created pack pool.
"""
from __future__ import annotations

import math
import os
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dicom import codec
from repro_torch.dicom.devices import Rect
from repro_torch.kernels.fused.ops import fused_scrub_residuals
from repro_torch.kernels.jls import entropy
from repro_torch.kernels.scrub.ops import pack_rects, scrub_images
from repro_torch.kernels.textdetect.ops import row_hits
from repro_torch.kernels.textdetect.ref import row_hits_np
from repro_torch.obs.metrics import Gauge, StatsShim
from repro_torch.obs.trace import NULL_TRACER

_CODEC_DTYPES = ("uint8", "uint16")


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _pow2_at_least(n: int, cap: Optional[int] = None) -> int:
    p = 1
    while p < n:
        p *= 2
    if cap is not None:
        # the cap itself must be a power of two or min() could hand back a
        # non-power-of-two batch dim, silently growing the jit-cache shape set
        p = min(p, _pow2_floor(cap))
    return p


def blank_inplace(pixels: np.ndarray, rects: Sequence[Rect]) -> np.ndarray:
    """Zero the rectangles in place (same clamping as ``scrub.numpy_blank``,
    minus the full-frame copy — callers own the array)."""
    H, W = pixels.shape[:2]
    for x, y, w, h in rects:
        pixels[max(0, y) : max(0, min(H, y + h)), max(0, x) : max(0, min(W, x + w))] = 0
    return pixels


@dataclass
class BatchOutput:
    """Per-instance result: blanked pixels + the full RJLS stream (or None
    when recompression was off)."""

    pixels: np.ndarray
    payload: Optional[bytes] = None


class _GaugeSet(set):
    """Set whose cardinality mirrors into a gauge on every mutation — keeps
    the historical ``stats.bucket_keys``/``padded_shapes`` set surface (adds,
    membership, iteration) while the count lives in the metrics plane."""

    def __init__(self, gauge: Gauge):
        super().__init__()
        self._gauge = gauge

    def _sync(self) -> None:
        self._gauge.set(len(self))

    def add(self, item) -> None:
        super().add(item)
        self._sync()

    def update(self, *others) -> None:
        super().update(*others)
        self._sync()

    def discard(self, item) -> None:
        super().discard(item)
        self._sync()

    def clear(self) -> None:
        super().clear()
        self._sync()


class ExecutorStats(StatsShim):
    """Dispatch accounting for :class:`BatchedDeidExecutor`, backed by the
    metrics registry (the last ad-hoc stats dataclass to migrate).

    Counter fields keep their exact historical meaning; ``bucket_keys`` and
    ``padded_shapes`` remain real sets (distinct-key semantics) whose sizes
    are exported as gauges. ``MetricsConservation`` cross-checks the
    registry's ``repro_executor_instances`` total against the worker pool's
    independently kept per-worker dispatch deltas.
    """

    _SUBSYSTEM = "executor"
    _FIELDS = (
        "instances",         # instances that went through a batched dispatch
        "dispatches",        # device calls issued
        "dispatch_groups",   # (run, bucket) groups — counts repeats per run
        "detect_instances",  # instances scanned by the text-band detector
        "detect_dispatches", # detector device calls issued
    )

    def __init__(self, registry=None) -> None:
        super().__init__(registry)
        # distinct keys ever / jit-cache keys
        self.bucket_keys: Set[tuple] = _GaugeSet(
            Gauge("repro_executor_bucket_keys", registry=self.registry))
        self.padded_shapes: Set[tuple] = _GaugeSet(
            Gauge("repro_executor_padded_shapes", registry=self.registry))

    @property
    def buckets(self) -> int:
        """Distinct bucket keys seen across all runs (repeat keys in later
        runs don't re-count — ``dispatch_groups`` has the per-run tally)."""
        return len(self.bucket_keys)


class _Chunk:
    """One in-flight dispatch: staging buffers, device handles, pending
    host pack jobs."""

    __slots__ = (
        "idxs", "H", "W", "dtype_name", "rb", "bits", "kind",
        "staged", "copied", "res", "u", "rs", "scrubbed", "jobs", "t_submit",
    )

    def __init__(self, idxs, H, W, dtype_name, rb):
        self.idxs = idxs
        self.H, self.W, self.dtype_name, self.rb = H, W, dtype_name, rb
        self.bits = np.dtype(dtype_name).itemsize * 8
        self.kind = "done"
        # pinned host tensors the H2D copies read, and the event recorded
        # after those copies: the staging buffers stay referenced here until
        # the event has completed, so a later chunk can never overwrite them
        self.staged: tuple = ()
        self.copied: Optional[torch.cuda.Event] = None
        self.res = self.u = self.rs = self.scrubbed = None
        self.jobs: Optional[list] = None
        self.t_submit: Optional[float] = None


class BatchedDeidExecutor:
    """Groups a study's instances into shape buckets and runs the fused
    scrub+residual kernel once per bucket chunk, pipelined against the host
    entropy tail.

    ``device`` defaults to ``cuda:0`` and raises without CUDA.
    ``use_kernel=None`` means the kernel path on a CUDA device and the host
    two-pass (``blank_inplace`` + ``codec.residuals``) on the CPU, as the JAX
    package does on its CPU backend. ``use_kernel=True`` on the CPU runs the
    same device-path code through the kernels' plain PyTorch versions.
    Bucketing/chunking (and the dispatch statistics) are identical either
    way.

    ``pipeline_depth`` is the max number of chunks in flight (1 disables
    overlap — strict submit-then-collect). ``host_workers`` sizes the pack
    pool (None auto-sizes, 0 runs pack jobs inline on the collect thread).
    ``device_entropy`` gates the Rice plan pre-pass (None follows
    ``use_kernel``). None of these change a single output byte — only where
    and when the work runs.
    """

    def __init__(
        self,
        max_batch: int = 32,
        bh: int = 64,
        use_kernel: Optional[bool] = None,
        tracer=None,
        host_workers: Optional[int] = None,
        pipeline_depth: int = 2,
        device_entropy: Optional[bool] = None,
        registry=None,
        device: DeviceLike = None,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        # normalize to a power of two so every padded batch dim stays inside
        # the closed shape set
        self.max_batch = _pow2_floor(max_batch)
        self.bh = bh
        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        self.host_workers = host_workers
        self.pipeline_depth = pipeline_depth
        self.device_entropy = device_entropy
        self.stats = ExecutorStats(registry)
        # per-dispatch profiling spans (kernel.dispatch / kernel.entropy_code)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._pool: Optional[ThreadPoolExecutor] = None

    def _resolve_use_kernel(self) -> bool:
        if self.use_kernel is None:
            self.use_kernel = self.device.type == "cuda"
        return self.use_kernel

    def _use_device_entropy(self, use_kernel: bool) -> bool:
        if self.device_entropy is not None:
            return bool(self.device_entropy) and use_kernel
        return use_kernel

    # ------------------------------------------------------------ pack pool
    def _resolve_workers(self) -> int:
        if self.host_workers is not None:
            return max(0, int(self.host_workers))
        return min(4, os.cpu_count() or 1)

    def _ensure_pool(self) -> Optional[ThreadPoolExecutor]:
        if self._resolve_workers() <= 0:
            return None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._resolve_workers(), thread_name_prefix="rice-pack"
            )
        return self._pool

    def close(self) -> None:
        """Shut down the pack pool (idempotent; the executor stays usable —
        the pool is recreated lazily on the next run)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _submit_jobs(self, fns) -> list:
        """Queue pure per-instance pack jobs; inline thunks when pool is off.
        Job order == chunk order either way, so drain order (and therefore
        every output byte) is independent of the pool size."""
        pool = self._ensure_pool()
        if pool is None:
            return list(fns)  # evaluated lazily, in order, on collect
        return [pool.submit(fn) for fn in fns]

    @staticmethod
    def _job_result(job):
        return job.result() if hasattr(job, "result") else job()

    # ------------------------------------------------------------- planning
    def supports(self, pixels: Optional[np.ndarray], recompress: bool) -> bool:
        """Batchable: single-plane 2D frames; recompression further requires a
        codec dtype. Everything else takes the per-instance fallback path."""
        if pixels is None or pixels.ndim != 2:
            return False
        if recompress:
            return pixels.dtype.name in _CODEC_DTYPES
        return pixels.dtype.kind in "uif"

    def bucket(
        self, items: Sequence[Tuple[np.ndarray, Sequence[Rect]]]
    ) -> Dict[tuple, List[int]]:
        """Group item indices by (H, W, dtype, rect-count bucket)."""
        buckets: Dict[tuple, List[int]] = defaultdict(list)
        for i, (pixels, rects) in enumerate(items):
            rb = _pow2_at_least(max(len(rects), 1))
            buckets[(pixels.shape[0], pixels.shape[1], pixels.dtype.name, rb)].append(i)
        return dict(buckets)

    # ------------------------------------------------------------- dispatch
    def run(
        self,
        items: Sequence[Tuple[np.ndarray, Sequence[Rect]]],
        *,
        sv: int = 1,
        recompress: bool = True,
    ) -> List[BatchOutput]:
        """Scrub (and recompress) a heterogeneous batch.

        items: per instance (pixels, rects). Pixels are blanked in place —
        callers pass freshly copied arrays (``ScrubStage`` copies the dataset
        first). Returns outputs aligned with ``items``.

        Submission and collection are pipelined: up to ``pipeline_depth``
        chunks are dispatched (device work queued asynchronously) before the
        oldest chunk's host entropy tail is drained, and chunks are always
        collected in submission order. On any failure the in-flight pack
        jobs are cancelled and the exception propagates — callers never see
        a partially filled output list.
        """
        use_kernel = self._resolve_use_kernel()
        out: List[Optional[BatchOutput]] = [None] * len(items)
        buckets = self.bucket(items)
        self.stats.bucket_keys.update(buckets.keys())
        self.stats.dispatch_groups += len(buckets)
        depth = max(1, int(self.pipeline_depth))
        inflight: deque = deque()
        try:
            for (H, W, dtype_name, rb), idxs in buckets.items():
                for c0 in range(0, len(idxs), self.max_batch):
                    chunk = idxs[c0 : c0 + self.max_batch]
                    inflight.append(
                        self._submit_chunk(
                            items, chunk, H, W, dtype_name, rb, sv, recompress, use_kernel
                        )
                    )
                    while len(inflight) >= depth:
                        self._collect_chunk(items, inflight.popleft(), sv, out)
            while inflight:
                self._collect_chunk(items, inflight.popleft(), sv, out)
        except BaseException:
            # crash containment: nothing submitted may leak — cancel queued
            # pack jobs (running ones are pure and write no shared state)
            # and let the exception escape with `out` discarded.
            for st in inflight:
                for job in st.jobs or ():
                    if hasattr(job, "cancel"):
                        job.cancel()
                self._release_staging(st)
            raise
        return out  # every index was bucketed exactly once

    # -- submit phase ------------------------------------------------------
    def _submit_chunk(
        self, items, chunk, H, W, dtype_name, rb, sv, recompress, use_kernel
    ) -> _Chunk:
        st = _Chunk(chunk, H, W, dtype_name, rb)
        clk = getattr(self.tracer, "clock", None)
        st.t_submit = clk.now() if clk is not None else None
        self.stats.dispatches += 1
        self.stats.instances += len(chunk)
        bytes_in = sum(items[i][0].nbytes for i in chunk)
        with self.tracer.span(
            "kernel.dispatch",
            path="fused" if use_kernel else "host",
            batch=len(chunk),
            shape=f"{H}x{W}",
            dtype=dtype_name,
            bucket=rb,
            bytes_in=bytes_in,
        ):
            if use_kernel:
                self._submit_kernel(items, st, sv, recompress)
            else:
                self._submit_host(items, st, sv, recompress)
        return st

    def _stage(self, array: np.ndarray) -> torch.Tensor:
        """Host tensor holding ``array``, copied into pinned memory when the
        copy goes to a card."""
        t = torch.from_numpy(array)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _stage_planes(self, planes, n_pad: int, H: int, W: int, dtype_name: str) -> torch.Tensor:
        """(n_pad, H, W) host tensor holding ``planes`` then zero planes,
        each plane written once, straight into pinned memory when the copy
        goes to a card."""
        t = torch.empty((n_pad, H, W), dtype=getattr(torch, dtype_name),
                        pin_memory=self.device.type == "cuda")
        view = t.numpy()
        for j, plane in enumerate(planes):
            view[j] = plane
        view[len(planes):] = 0
        return t

    def _submit_kernel(self, items, st, sv, recompress) -> None:
        """Stage one padded chunk, copy it to the device and queue the fused
        (or scrub-only) kernels; device values stay asynchronous until
        collect."""
        chunk, H, W = st.idxs, st.H, st.W
        n = len(chunk)
        n_pad = _pow2_at_least(n, self.max_batch)
        rects = np.zeros((n_pad, st.rb, 4), np.int32)
        rects[:n] = pack_rects([list(items[i][1]) for i in chunk], R=st.rb)
        self.stats.padded_shapes.add((n_pad, H, W, st.dtype_name, st.rb))

        st.staged = (self._stage_planes([items[i][0] for i in chunk], n_pad, H, W, st.dtype_name),
                     self._stage(rects))
        images_d, rects_d = (t.to(self.device, non_blocking=True) for t in st.staged)
        if self.device.type == "cuda":
            st.copied = torch.cuda.Event()
            st.copied.record()

        if recompress:
            res = fused_scrub_residuals(images_d, rects_d, sv=sv, bits=st.bits, bh=self.bh)
            if self._use_device_entropy(True):
                st.u, st.rs = entropy.rice_prepass(res, bh=self.bh)
                st.kind = "device_plan"
            else:
                st.res = res
                st.kind = "device_res"
            # host-side pixel blanking for the delivered object (banner
            # pixels only) happens at submit so collect is pure codec work;
            # the staged copy, not these arrays, feeds the device
            for i in chunk:
                blank_inplace(items[i][0], items[i][1])
        else:
            st.scrubbed = scrub_images(images_d, rects_d)
            st.kind = "scrub_only"

    def _release_staging(self, st: _Chunk) -> None:
        if st.copied is not None:
            st.copied.synchronize()
            st.copied = None
        st.staged = ()

    def _submit_host(self, items, st, sv, recompress) -> None:
        """CPU path: blank + batched residuals now, queue the encode tail."""
        chunk = st.idxs
        for i in chunk:
            blank_inplace(items[i][0], items[i][1])
        if recompress:
            # per-instance residuals (not residuals_batch): one plane's int64
            # intermediates stay cache-resident, a whole chunk's do not
            st.jobs = self._submit_jobs(
                [
                    lambda px=items[i][0]: codec.rice_encode(codec.residuals(px, sv))
                    for i in chunk
                ]
            )
            st.kind = "host_encode"
        else:
            st.kind = "done"

    # -- collect phase -----------------------------------------------------
    def _collect_chunk(self, items, st: _Chunk, sv, out) -> None:
        chunk, H, W = st.idxs, st.H, st.W
        clk = getattr(self.tracer, "clock", None)

        if st.kind in ("done", "scrub_only"):
            # the scrub-only collect: the copy back into pageable memory and
            # into each dataset (wait_s = until the copy back has returned)
            with self.tracer.stage("kernel.collect", batch=len(chunk), path=st.kind) as sp:
                t0 = clk.now() if sp.span is not None else None
                if st.kind == "scrub_only":
                    scrubbed = st.scrubbed.cpu().numpy()  # blocks on the device here
                    self._release_staging(st)
                if t0 is not None:
                    sp.set(wait_s=round(clk.now() - t0, 9))
                for j, i in enumerate(chunk):
                    pixels = items[i][0]
                    if st.kind == "scrub_only":
                        pixels[...] = scrubbed[j]
                    out[i] = BatchOutput(pixels=pixels)
            return

        # recompress paths: the host Golomb-Rice tail — its own span so a
        # trace shows the host/device boundary (queue_s = how long the chunk
        # sat in flight behind newer dispatches, wait_s = device sync time)
        # NB: pool size / pipeline depth are deliberately NOT span attrs —
        # the trace digest must be identical for any host_workers setting
        with self.tracer.span(
            "kernel.entropy_code", batch=len(chunk), path=st.kind
        ) as sp:
            t0 = clk.now() if clk is not None else None
            if st.kind == "device_plan":
                n = len(chunk)
                rs = st.rs[:n].cpu().numpy()  # device sync point
                self._release_staging(st)
                # k from the exact int64 total of the int32 row sums: a DX
                # plane's total passes 2^31
                ks = np.array(
                    [codec._rice_k_from_sum(int(rs[j].sum(dtype=np.int64)), H * W)
                     for j in range(n)],
                    np.int32,
                )
                # lengths/remainders and the copies back cover the real
                # instances only, not the batch padding
                u = st.u[:n]
                lens_d, rem_d = entropy.rice_len_rem(u, ks, bh=self.bh)
                # the pack jobs see host numpy arrays only
                u_np = u.cpu().numpy().reshape(n, -1)
                lens_np, rem_np = lens_d.cpu().numpy(), rem_d.cpu().numpy()
                st.jobs = self._submit_jobs(
                    [
                        lambda j=j: codec.rice_pack(
                            codec.rice_plan_from_prepass(
                                u_np[j], int(ks[j]), lens_np[j], rem_np[j]
                            )
                        )
                        for j in range(len(chunk))
                    ]
                )
                kparams = [int(k) for k in ks]
            elif st.kind == "device_res":
                res = st.res[: len(chunk)].cpu().numpy()  # device sync point
                self._release_staging(st)
                st.jobs = self._submit_jobs(
                    [lambda rj=res[j]: codec.rice_encode(rj) for j in range(len(chunk))]
                )
                kparams = None
            else:  # host_encode — jobs were queued at submit
                kparams = None
            t1 = clk.now() if clk is not None else None

            total = 0
            for j, i in enumerate(chunk):
                result = self._job_result(st.jobs[j])
                if kparams is not None:
                    payload, k = result, kparams[j]
                else:
                    payload, k = result
                total += len(payload)
                out[i] = BatchOutput(
                    pixels=items[i][0],
                    payload=codec.pack_header(H, W, st.bits, sv, k, len(payload))
                    + payload,
                )
            sp.set(bytes_out=total)
            if clk is not None:
                sp.set(
                    queue_s=round(t0 - st.t_submit, 9),
                    wait_s=round(t1 - t0, 9),
                )

    # ------------------------------------------------------------- detection
    def detect_row_hits(
        self,
        entries: Sequence[Tuple[np.ndarray, float]],
        *,
        tile: Tuple[int, int] = (32, 128),
    ) -> List[np.ndarray]:
        """Batched text-band profile pass for the burned-in-PHI detector.

        entries: per instance (2D pixels, binarization threshold). Instances
        are bucketed by (H, W, dtype, threshold) — the detector rides the
        same shape-uniform dispatch discipline as the scrub kernel — and each
        chunk is one ``kernels/textdetect`` call on the device path (the CUDA
        kernel on the card, its plain version on the CPU) or the
        bit-identical numpy oracle on the host path. The pass is synchronous:
        the scrub stage needs the row hits on the host to resolve rects.
        Returns per-instance (H,) int32 row glyph-hit profiles aligned with
        ``entries``.
        """
        use_kernel = self._resolve_use_kernel()
        out: List[Optional[np.ndarray]] = [None] * len(entries)
        buckets: Dict[tuple, List[int]] = defaultdict(list)
        for i, (pixels, thresh) in enumerate(entries):
            t = float(thresh)
            # a NaN key never equals itself: every instance would land in its
            # own bucket and get a private dispatch — reject it at the door
            if not math.isfinite(t):
                raise ValueError(
                    f"detector threshold must be finite, got {t!r} (entry {i})"
                )
            buckets[(pixels.shape[0], pixels.shape[1], pixels.dtype.name, t)].append(i)
        for (H, W, dtype_name, thresh), idxs in buckets.items():
            for c0 in range(0, len(idxs), self.max_batch):
                chunk = idxs[c0 : c0 + self.max_batch]
                self.stats.detect_dispatches += 1
                self.stats.detect_instances += len(chunk)
                with self.tracer.span(
                    "kernel.detect_dispatch",
                    path="textdetect" if use_kernel else "oracle",
                    batch=len(chunk),
                    shape=f"{H}x{W}",
                    dtype=dtype_name,
                    bytes_in=sum(entries[i][0].nbytes for i in chunk),
                ):
                    if use_kernel:
                        hits = self._detect_kernel(entries, chunk, H, W, dtype_name, thresh, tile)
                    else:
                        stack = np.stack([entries[i][0] for i in chunk])
                        hits = row_hits_np(stack, thresh, tile)
                    for j, i in enumerate(chunk):
                        out[i] = hits[j]
        return out  # every index was bucketed exactly once

    def _detect_kernel(self, entries, chunk, H, W, dtype_name, thresh, tile) -> np.ndarray:
        """One padded detector chunk through the textdetect op: staged in
        pinned memory, copied to the device, profiled, reduced to row hits
        there, and the (n, H) int32 result of the real instances copied
        back."""
        n = len(chunk)
        # pad the batch dim like the fused path: the set of padded shapes
        # stays small and closed
        n_pad = _pow2_at_least(n, self.max_batch)
        self.stats.padded_shapes.add((n_pad, H, W, dtype_name, "detect"))
        staged = self._stage_planes([entries[i][0] for i in chunk], n_pad, H, W, dtype_name)
        images_d = staged.to(self.device, non_blocking=True)
        # the copy back waits for the kernel, and the kernel for the upload,
        # so the staging buffer outlives its copy
        return row_hits(images_d, thresh=thresh, tile=tile)[:n].cpu().numpy()

