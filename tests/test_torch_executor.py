"""The port's BatchedDeidExecutor against the JAX package's: the same bucket
and power-of-two padding rules, payload bytes identical to the JAX executor
and the host codec, invariant to pool size and pipeline depth, the same
trace digest for the same path kind, and no partial batch after a crash.

On the CPU ``use_kernel=True`` drives the device-path code through the
kernels' plain PyTorch versions (the counterpart of the JAX package's
interpret mode); ``tests/test_torch_gpu.py`` runs the CUDA kernels on the
card.
"""
import numpy as np
import pytest
import torch

from repro.core.batch import BatchedDeidExecutor as JaxExecutor
from repro.core.scrub import numpy_blank
from repro.dicom import codec as jax_codec
from repro.utils.timing import SimClock

from repro_torch.core.batch import (
    BatchedDeidExecutor,
    _pow2_at_least,
    _pow2_floor,
    blank_inplace,
)
from repro_torch.dicom import codec
from repro_torch.obs.trace import Tracer


def _ex(**kw):
    return BatchedDeidExecutor(device="cpu", **kw)


def _mk_items(rng, n=10):
    items = []
    for i in range(n):
        shape = (60, 80) if i % 3 else (48, 48)
        dtype = np.uint16 if i % 2 else np.uint8
        px = rng.integers(0, np.iinfo(dtype).max, size=shape).astype(dtype)
        items.append((px, [(4, 4, 24, 8)] if i % 4 else []))
    return items


def _run(ex, items, sv=2, **kw):
    return ex.run([(px.copy(), list(rl)) for px, rl in items], sv=sv, **kw)


class TestDeviceRule:
    def test_default_device_is_cuda_or_raises(self):
        if torch.cuda.is_available():
            assert BatchedDeidExecutor().device == torch.device("cuda:0")
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                BatchedDeidExecutor()

    def test_cpu_defaults_to_host_path(self, rng):
        tracer = Tracer(SimClock())
        ex = _ex(tracer=tracer)
        _run(ex, _mk_items(rng, n=2))
        assert ex.use_kernel is False
        assert {sp.attrs["path"] for sp in tracer.spans("kernel.dispatch")} == {"host"}

    @pytest.mark.parametrize("use_kernel", [None, True])
    def test_detect_row_hits_equals_jax(self, rng, use_kernel):
        """detect_row_hits equals the JAX executor's (row hits, padded
        shapes, dispatch counts) and the numpy oracle, on either path."""
        entries = [((rng.random((40, 150)) * 4095).astype(np.uint16), 2457.0) for _ in range(3)]
        entries.append((np.full((32, 128), 200, np.uint8), 153.0))
        ex = _ex(max_batch=2, use_kernel=use_kernel)
        ref = JaxExecutor(max_batch=2, use_kernel=bool(use_kernel))
        got, want = ex.detect_row_hits(entries), ref.detect_row_hits(entries)
        for g, w, (px, t) in zip(got, want, entries):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, (px.astype(np.float32) >= np.float32(t)).sum(1))
        assert ex.stats.padded_shapes == ref.stats.padded_shapes
        assert (ex.stats.detect_dispatches, ex.stats.detect_instances) == (3, 4)


class TestBucketing:
    def test_groups_by_shape_dtype_and_rect_bucket(self, rng):
        items = [
            ((rng.random((64, 64)) * 255).astype(np.uint8), [(0, 0, 8, 8)]),
            ((rng.random((64, 64)) * 255).astype(np.uint8), [(1, 1, 4, 4)]),
            ((rng.random((64, 64)) * 4095).astype(np.uint16), [(0, 0, 8, 8)]),
            ((rng.random((32, 64)) * 255).astype(np.uint8), [(0, 0, 8, 8)]),
            ((rng.random((64, 64)) * 255).astype(np.uint8), [(0, 0, 8, 8)] * 3),
        ]
        buckets = _ex().bucket(items)
        assert buckets == JaxExecutor().bucket(items)
        assert sorted(buckets.values()) == [[0, 1], [2], [3], [4]]
        assert (64, 64, "uint8", 4) in buckets

    def test_zero_rects_bucket_as_one(self, rng):
        px = (rng.random((16, 16)) * 255).astype(np.uint8)
        assert len(_ex().bucket([(px, []), (px.copy(), [(0, 0, 4, 4)])])) == 1

    @pytest.mark.parametrize("recompress", [False, True])
    def test_padded_shapes_are_powers_of_two(self, rng, recompress):
        items = [((rng.random((32, 48) if i < 11 else (16, 48)) * 255).astype(np.uint8), [])
                 for i in range(13)]
        ex = _ex(max_batch=8, use_kernel=True)
        ref = JaxExecutor(max_batch=8, use_kernel=True)
        _run(ex, items, recompress=recompress)
        _run(ref, items, recompress=recompress)
        assert ex.stats.padded_shapes == ref.stats.padded_shapes
        assert {s[0] for s in ex.stats.padded_shapes} <= {2, 4, 8}
        assert ex.stats.instances == 13 and ex.stats.dispatches == 3

    def test_pow2_rules(self):
        assert _pow2_at_least(20, 24) == 16
        assert _pow2_at_least(20, 32) == 32
        assert _pow2_at_least(5, 24) == 8
        assert _pow2_floor(24) == 16 and _pow2_floor(32) == 32
        assert _ex(max_batch=24).max_batch == 16
        with pytest.raises(ValueError):
            _ex(max_batch=0)

    def test_stats_buckets_count_distinct_keys_across_runs(self, rng):
        ex = _ex(use_kernel=False)
        items = [((rng.random((24, 24)) * 255).astype(np.uint8), []) for _ in range(3)]
        _run(ex, items)
        _run(ex, items)
        assert ex.stats.buckets == 1 and ex.stats.dispatch_groups == 2

    def test_supports(self):
        ex = _ex()
        assert ex.supports(np.zeros((8, 8), np.uint16), recompress=True)
        assert not ex.supports(None, recompress=True)
        assert not ex.supports(np.zeros((8, 8, 3), np.uint8), recompress=True)
        assert not ex.supports(np.zeros((8, 8), np.float32), recompress=True)
        assert ex.supports(np.zeros((8, 8), np.float32), recompress=False)

    def test_blank_inplace_matches_numpy_blank(self, rng):
        img = (rng.random((30, 40)) * 255).astype(np.uint8)
        rl = [(-5, 10, 20, 99), (35, 25, 99, 99)]
        np.testing.assert_array_equal(blank_inplace(img.copy(), rl), numpy_blank(img, rl))


class TestOutputs:
    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_recompress_matches_host_pair_and_jax_executor(self, rng, use_kernel):
        imgs = rng.integers(0, 65536, size=(5, 60, 80)).astype(np.uint16)  # full range
        rls = [[(0, 0, 80, 10)], [], [(10, 10, 20, 20), (15, 15, 20, 20)], [(70, 50, 99, 99)], []]
        items = [(imgs[i], rls[i]) for i in range(5)]
        outs = _run(_ex(use_kernel=use_kernel), items, sv=3)
        ref = _run(JaxExecutor(use_kernel=False), items, sv=3)
        for i, (out, want) in enumerate(zip(outs, ref)):
            blanked = numpy_blank(imgs[i], rls[i])
            np.testing.assert_array_equal(out.pixels, blanked)
            assert out.payload == want.payload == jax_codec.encode(blanked, 3)
            np.testing.assert_array_equal(codec.decode(out.payload), blanked)

    def test_kernel_path_equals_jax_kernel_path(self, rng):
        items = _mk_items(rng, n=6)
        outs = _run(_ex(max_batch=4, use_kernel=True, host_workers=0), items)
        ref = _run(JaxExecutor(max_batch=4, use_kernel=True, host_workers=0), items)
        assert [o.payload for o in outs] == [o.payload for o in ref]

    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("dtype", [np.uint8, np.float32])
    def test_scrub_only_matches_numpy_blank(self, rng, use_kernel, dtype):
        imgs = (rng.random((3, 40, 52)) * 255).astype(dtype)
        rls = [[(2, 2, 10, 10)], [(0, 0, 52, 5)], []]
        outs = _run(_ex(use_kernel=use_kernel), [(imgs[i], rls[i]) for i in range(3)],
                    recompress=False)
        for i, out in enumerate(outs):
            assert out.pixels.dtype == dtype
            np.testing.assert_array_equal(out.pixels, numpy_blank(imgs[i], rls[i]))
            assert out.payload is None

    def test_device_entropy_off_uses_residual_path(self, rng):
        tracer = Tracer(SimClock())
        items = _mk_items(rng, n=3)
        outs = _run(_ex(use_kernel=True, device_entropy=False, tracer=tracer), items)
        assert {sp.attrs["path"] for sp in tracer.spans("kernel.entropy_code")} == {"device_res"}
        ref = _run(_ex(use_kernel=False), items)
        assert [o.payload for o in outs] == [o.payload for o in ref]


class TestOverlap:
    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_bytes_identical_across_pool_and_depth(self, rng, use_kernel):
        items = _mk_items(rng)
        ref = None
        for host_workers in (0, 3):
            for depth in (1, 2, 4):
                ex = _ex(max_batch=4, use_kernel=use_kernel, host_workers=host_workers,
                         pipeline_depth=depth)
                outs = _run(ex, items)
                got = ([o.payload for o in outs], [o.pixels.tobytes() for o in outs])
                if ref is None:
                    ref = got
                else:
                    assert got == ref, (host_workers, depth)
                ex.close()

    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_trace_digest_equals_jax_executor(self, rng, use_kernel):
        items = _mk_items(rng, n=7)
        digests = []
        for make in (JaxExecutor, _ex):
            tracer = Tracer(SimClock()) if make is _ex else None
            if tracer is None:
                from repro.obs.trace import Tracer as JaxTracer

                tracer = JaxTracer(SimClock())
            ex = make(max_batch=4, use_kernel=use_kernel, host_workers=2, pipeline_depth=2,
                      tracer=tracer)
            _run(ex, items)
            ex.close()
            assert tracer.spans("kernel.entropy_code")
            digests.append(tracer.digest())
        assert digests[0] == digests[1]

    def test_entropy_span_carries_boundary_timing(self, rng):
        tracer = Tracer(SimClock())
        ex = _ex(max_batch=4, use_kernel=True, host_workers=0, tracer=tracer)
        _run(ex, _mk_items(rng, n=4))
        spans = tracer.spans("kernel.entropy_code")
        assert spans and {sp.attrs["path"] for sp in spans} == {"device_plan"}
        for sp in spans:
            assert {"queue_s", "wait_s", "bytes_out"} <= set(sp.attrs)
        assert {sp.attrs["path"] for sp in tracer.spans("kernel.dispatch")} == {"fused"}
        assert len(tracer.spans("kernel.dispatch")) == len(spans)


class TestCrashMidOverlap:
    @pytest.mark.parametrize("use_kernel,target", [(False, "rice_encode"), (True, "rice_pack")])
    def test_no_partial_batch_escapes(self, rng, monkeypatch, use_kernel, target):
        items = _mk_items(rng, n=12)
        calls = {"n": 0}
        real = getattr(codec, target)

        def flaky(*a):
            calls["n"] += 1
            if calls["n"] == 7:  # mid-run: some chunks already collected
                raise RuntimeError("entropy coder died mid-overlap")
            return real(*a)

        monkeypatch.setattr(codec, target, flaky)
        ex = _ex(max_batch=4, use_kernel=use_kernel, host_workers=3, pipeline_depth=3)
        with pytest.raises(RuntimeError, match="mid-overlap"):
            _run(ex, items)
        monkeypatch.setattr(codec, target, real)
        outs = _run(ex, items)  # the executor and its pool stay usable
        ref = _run(_ex(max_batch=4, use_kernel=False, host_workers=0), items)
        assert [o.payload for o in outs] == [o.payload for o in ref]
        ex.close()

    def test_inline_mode_crash_equivalent(self, rng, monkeypatch):
        def boom(res):
            raise RuntimeError("entropy coder died")

        monkeypatch.setattr(codec, "rice_encode", boom)
        with pytest.raises(RuntimeError, match="died"):
            _run(_ex(max_batch=4, use_kernel=False, host_workers=0), _mk_items(rng, n=6))
