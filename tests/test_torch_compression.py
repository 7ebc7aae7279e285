"""The port's gradient compression (``repro_torch.distributed.compression``)
against the JAX package's, on the CPU, from numpy seeds.

Tolerances, set beforehand: int8 payloads and scales **equal** (both round
half to even); top-k decompressed tensors equal on tie-free inputs (the two
libraries may order ties differently, so indices are compared as sets);
error-feedback residuals within 1e-7 absolute. The reference's own
``tests/test_distributed.py::TestCompression`` table is mirrored on the
port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as j_comp
from repro_torch import distributed as t_dist
from repro_torch.distributed import compression as t_comp


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def _tie_free(rng, shape, scale=1.0):
    """Normal draws whose magnitudes are all distinct."""
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    assert len(np.unique(np.abs(g))) == g.size
    return g


def test_package_exports_the_reference_names():
    from repro import distributed as j_dist

    names = {"int8_compress", "int8_decompress", "topk_compress", "topk_decompress", "CompressionState"}
    assert names <= set(j_dist.__all__) and names <= set(t_dist.__all__)
    for name in names:
        assert getattr(t_dist, name) is getattr(t_comp, name)


@pytest.mark.parametrize("shape,scale", [((128, 64), 1.0), ((1000,), 1e-3), ((7, 3, 5), 30.0), ((1,), 2.0)])
def test_int8_payload_and_scale_equal_reference(shape, scale):
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    res = (rng.standard_normal(shape) * scale * 0.01).astype(np.float32)
    qj, sj, stj = j_comp.int8_compress(_j(g), j_comp.CompressionState(_j(res)))
    qt, st, stt = t_comp.int8_compress(_t(g), t_comp.CompressionState(_t(res)))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(_np(qt), _np(qj))
    assert np.array_equal(_np(st), _np(sj))
    np.testing.assert_allclose(_np(stt.residual), _np(stj.residual), atol=1e-7, rtol=0)
    assert np.array_equal(_np(t_comp.int8_decompress(qt, st)), _np(j_comp.int8_decompress(qj, sj)))


def test_int8_rounds_half_to_even_as_reference():
    # a max of 127 makes the scale exactly 1, so g / scale keeps its halves
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
    qj, _, _ = j_comp.int8_compress(_j(g), j_comp.CompressionState.init(g.shape))
    qt, _, _ = t_comp.int8_compress(_t(g), t_comp.CompressionState.init(g.shape))
    assert _np(qt).tolist() == _np(qj).tolist() == [127, 0, 2, 2, 0, -2, 4]


def test_int8_error_feedback_chain_equals_reference():
    rng = np.random.default_rng(5)
    sj, stt = j_comp.CompressionState.init((1000,)), t_comp.CompressionState.init((1000,))
    tot_j, tot_t = np.zeros(1000, np.float32), np.zeros(1000, np.float32)
    for i in range(50):
        g = (rng.standard_normal(1000) * 1e-3).astype(np.float32)
        qj, scj, sj = j_comp.int8_compress(_j(g), sj)
        qt, sct, stt = t_comp.int8_compress(_t(g), stt)
        assert np.array_equal(_np(qt), _np(qj)), i
        np.testing.assert_allclose(_np(stt.residual), _np(sj.residual), atol=1e-7, rtol=0)
        tot_j += _np(j_comp.int8_decompress(qj, scj))
        tot_t += _np(t_comp.int8_decompress(qt, sct))
    np.testing.assert_allclose(tot_t, tot_j, atol=1e-7, rtol=0)


@pytest.mark.parametrize("shape,k_frac", [((100,), 0.1), ((64, 32), 0.05), ((5, 7, 9), 0.01), ((3,), 0.01)])
def test_topk_equals_reference_on_tie_free_inputs(shape, k_frac):
    rng = np.random.default_rng(int(np.prod(shape)))
    g = _tie_free(rng, shape)
    res = _tie_free(rng, shape, 1e-4)
    vj, ij, stj = j_comp.topk_compress(_j(g), j_comp.CompressionState(_j(res)), k_frac=k_frac)
    vt, it, stt = t_comp.topk_compress(_t(g), t_comp.CompressionState(_t(res)), k_frac=k_frac)
    assert vt.shape == vj.shape and set(_np(it).tolist()) == set(_np(ij).tolist())
    n = int(np.prod(shape))
    dj = _np(j_comp.topk_decompress(vj, ij, shape, n))
    dt = _np(t_comp.topk_decompress(vt, it, shape, n))
    assert np.array_equal(dt, dj)
    np.testing.assert_allclose(_np(stt.residual), _np(stj.residual), atol=1e-7, rtol=0)


def test_topk_error_feedback_chain_equals_reference():
    rng = np.random.default_rng(9)
    g = _tie_free(rng, (256,))
    sj, stt = j_comp.CompressionState.init(g.shape), t_comp.CompressionState.init(g.shape)
    for i in range(20):
        acc = np.abs(g + _np(stt.residual))
        assert len(np.unique(acc)) == acc.size, i  # the step's input is tie-free too
        vj, ij, sj = j_comp.topk_compress(_j(g), sj, k_frac=0.05)
        vt, it, stt = t_comp.topk_compress(_t(g), stt, k_frac=0.05)
        assert set(_np(it).tolist()) == set(_np(ij).tolist()), i
        np.testing.assert_allclose(_np(stt.residual), _np(sj.residual), atol=1e-7, rtol=0)


# ------------------------------------ the reference's TestCompression, on the port
def test_int8_roundtrip_accuracy():
    g = _t(np.random.default_rng(0).normal(size=(128, 64)).astype(np.float32))
    q, scale, _ = t_comp.int8_compress(g, t_comp.CompressionState.init(g.shape))
    deq = t_comp.int8_decompress(q, scale)
    assert q.dtype == torch.int8
    assert float(torch.max(torch.abs(deq - g))) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_accumulates():
    g = _t(np.random.default_rng(1).normal(size=(1000,)).astype(np.float32)) * 1e-3
    st = t_comp.CompressionState.init(g.shape)
    total = torch.zeros_like(g)
    for _ in range(50):
        q, s, st = t_comp.int8_compress(g, st)
        total = total + t_comp.int8_decompress(q, s)
    err = float(torch.linalg.norm(total - 50 * g)) / float(torch.linalg.norm(50 * g))
    assert err < 0.05, err


def test_topk_keeps_largest():
    g = _t(np.arange(100, dtype=np.float32) - 50)
    vals, idx, st = t_comp.topk_compress(g, t_comp.CompressionState.init(g.shape), k_frac=0.1)
    assert vals.shape == (10,)
    deq = t_comp.topk_decompress(vals, idx, g.shape, g.numel())
    mags = np.abs(g.numpy())
    assert all(mags[i] >= 45 for i in idx.tolist()) and len(set(idx.tolist())) == 10
    np.testing.assert_allclose((st.residual + deq).numpy(), g.numpy(), atol=1e-6)


def test_topk_error_feedback_recovers_small_coords():
    g = _t(np.random.default_rng(2).normal(size=(256,)).astype(np.float32))
    st = t_comp.CompressionState.init(g.shape)
    total = torch.zeros_like(g)
    for _ in range(200):
        vals, idx, st = t_comp.topk_compress(g, st, k_frac=0.05)
        total = total + t_comp.topk_decompress(vals, idx, g.shape, g.numel())
    err = float(torch.linalg.norm(total / 200 - g)) / float(torch.linalg.norm(g))
    assert err < 0.1, err


def test_compression_state_init_places_zeros():
    st = t_comp.CompressionState.init((3, 4), device="cpu")
    assert st.residual.dtype == torch.float32 and st.residual.shape == (3, 4)
    assert not st.residual.any()
