"""The port's LM model zoo (``repro_torch.config``, ``configs``, ``models``)
against the JAX package's, on the CPU.

Inputs come from numpy seeds; the port's weights are the JAX ``init``'s,
carried across with ``carry.model_params_from_numpy``. Tolerances, set
beforehand from the dtype: attention 2e-5 (f32); MoE 2e-4 with rtol 1e-3;
SSM blocks and whole models 1e-4 (atol and rtol) in f32; a bf16 config 3e-2.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import model as j_config
from repro.config.registry import get_arch as j_get_arch, list_archs as j_list_archs
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro.models.spec import param_count as j_param_count, tree_init as j_tree_init
from repro.models.spec import tree_logical_axes as j_tree_logical_axes
from repro_torch.carry import model_params_from_numpy
from repro_torch.config import model as t_config
from repro_torch.config.registry import get_arch as t_get_arch, list_archs as t_list_archs
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model as t_build_model
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm
from repro_torch.models.spec import TensorSpec, param_count, tree_init, tree_items, tree_logical_axes

ARCHS = j_list_archs()
DECODE_ARCHS = [a for a in ARCHS if j_get_arch(a).has_decode]
F32 = dict(atol=1e-4, rtol=1e-4)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def jit(fn, **static):
    """The JAX reference compiled once (faster on the CPU than op by op)."""
    return jax.jit(functools.partial(fn, **static))


def _t_cfg(jcfg):
    """The port's config with the JAX config's fields."""
    return t_config.ModelConfig(**dataclasses.asdict(jcfg))


def _normal(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(arr):
    return jnp.asarray(arr), torch.from_numpy(np.array(arr))


def _j_flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _j_flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _spec_rows_j(tree):
    return {p: (tuple(s.shape), tuple(s.axes), np.dtype(s.dtype).name, s.init, s.scale)
            for p, s in _j_flat(tree)}


def _spec_rows_t(tree):
    return {p: (tuple(s.shape), tuple(s.axes), str(s.dtype).removeprefix("torch."), s.init, s.scale)
            for p, s in tree_items(tree)}


def _port_of(jmodel, jparams, cfg=None):
    """The port's model with the JAX model's config and weights."""
    model = t_build_model(_t_cfg(cfg or jmodel.cfg), "cpu", generator=torch.Generator().manual_seed(1))
    model_params_from_numpy(model, jax.tree.map(np.asarray, jparams))
    return model


# ------------------------------------------------------- config + registry
def test_registry_lists_the_same_archs():
    assert t_list_archs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    jc, tc = j_get_arch(arch), t_get_arch(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    for c_t, c_j in ((tc, jc), (tc.reduced(), jc.reduced())):
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
        for prop in ("hd", "d_inner", "ssm_nheads", "dt_rank", "attention_free", "has_decode",
                     "subquadratic"):
            assert getattr(c_t, prop) == getattr(c_j, prop), prop
        assert c_t.n_shared_attn() == c_j.n_shared_attn()


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_rules_equal_reference(arch):
    assert {k: dataclasses.asdict(v) for k, v in t_config.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_config.SHAPES.items()}
    for name in j_config.SHAPES:
        assert t_config.cell_runnable(t_get_arch(arch), t_config.SHAPES[name]) == \
            j_config.cell_runnable(j_get_arch(arch), j_config.SHAPES[name])


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        t_get_arch("gpt-5")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, reduced):
    jc, tc = j_get_arch(arch), t_get_arch(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    j_specs = j_build_model(jc).param_specs()
    t_specs = t_model.param_specs(tc)
    assert _spec_rows_t(t_specs) == _spec_rows_j(j_specs)
    assert param_count(t_specs) == j_param_count(j_specs)
    assert dict(tree_items(tree_logical_axes(t_specs))) == dict(_j_flat(j_tree_logical_axes(j_specs)))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_cache_specs_equal_reference(arch):
    for jc, tc in ((j_get_arch(arch), t_get_arch(arch)), (j_get_arch(arch).reduced(), t_get_arch(arch).reduced())):
        assert _spec_rows_t(t_model.cache_specs(tc, 3, 40)) == \
            _spec_rows_j(j_build_model(jc).cache_specs(3, 40))


def test_spec_dtype_defaults_to_bfloat16_even_in_float32_configs():
    assert TensorSpec((2,), (None,)).dtype == torch.bfloat16
    model = t_build_model(t_get_arch("qwen2-0.5b").reduced(), "cpu")
    assert model.dtype == torch.float32
    assert model.layers.attn.wq.dtype == torch.bfloat16
    assert model.layers.attn.wq.shape == (4, 128, 4 * 32)


def test_parameters_registered_under_reference_paths():
    cfg = t_get_arch("zamba2-2.7b").reduced()
    model = t_build_model(cfg, "cpu")
    names = dict(model.named_parameters())
    assert set(names) == set(p for p, _ in tree_items(model.param_specs()))
    assert names["groups.mamba.in_proj"].shape[:2] == (cfg.n_shared_attn(), cfg.attn_every)
    assert names["shared.attn.wq"].shape == (2 * cfg.d_model, cfg.n_heads * cfg.hd)


# ---------------------------------------------------------------- tree_init
def test_tree_init_is_seeded_and_follows_each_init():
    cfg = t_get_arch("falcon-mamba-7b").reduced()
    specs = t_ssm.mamba1_specs(cfg)
    a = tree_init(specs, torch.Generator().manual_seed(3))
    b = tree_init(specs, torch.Generator().manual_seed(3))
    c = tree_init(specs, torch.Generator().manual_seed(4))
    for path, leaf in tree_items(a):
        assert torch.equal(leaf, dict(tree_items(b))[path]), path
        assert leaf.dtype == dict(tree_items(specs))[path].dtype
    assert not torch.equal(a["in_proj"], c["in_proj"])
    assert torch.equal(a["conv_b"], torch.zeros_like(a["conv_b"]))
    assert torch.equal(a["D"], torch.ones_like(a["D"]))
    n = cfg.ssm_state
    assert torch.allclose(a["A_log"][0], torch.log(torch.arange(1, n + 1, dtype=torch.float32)))
    dt = torch.nn.functional.softplus(a["dt_b"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert abs(float(a["in_proj"].float().std()) - 0.02) < 0.002


# ------------------------------------------------------------------ carry
def test_model_params_from_numpy_checks_every_leaf():
    jm = j_build_model(j_get_arch("qwen2-0.5b").reduced())
    tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    model = t_build_model(t_get_arch("qwen2-0.5b").reduced(), "cpu")
    before = model.layers.attn.wq.detach().clone()

    missing = jax.tree.map(lambda x: x, tree)
    del missing["layers"]["attn"]["bq"]
    with pytest.raises(ValueError, match="missing.*layers.attn.bq"):
        model_params_from_numpy(model, missing)
    extra = {**tree, "bogus": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="unknown.*bogus"):
        model_params_from_numpy(model, extra)
    bad_shape = {**tree, "ln_f": np.ones(7, tree["ln_f"].dtype)}
    with pytest.raises(ValueError, match="ln_f: shape"):
        model_params_from_numpy(model, bad_shape)
    bad_dtype = {**tree, "ln_f": tree["ln_f"].astype(np.float32)}
    with pytest.raises(ValueError, match="ln_f: dtype float32"):
        model_params_from_numpy(model, bad_dtype)
    assert torch.equal(model.layers.attn.wq, before)  # nothing loaded on a refusal

    model_params_from_numpy(model, tree)
    want = np.asarray(tree["layers"]["attn"]["wq"]).astype(np.float32)
    assert np.array_equal(model.layers.attn.wq.detach().float().numpy(), want)


# ----------------------------------------------------------------- layers
def test_rms_norm_and_rope_equal_reference():
    rng = np.random.default_rng(0)
    xj, xt = _both(_normal(rng, (2, 8, 4, 32)))
    sj, st = _both(_normal(rng, (32,)))
    close(t_layers.rms_norm(xt, st, 1e-5), j_layers.rms_norm(xj, sj, 1e-5), atol=1e-6, rtol=1e-6)
    pos = np.arange(3, 11, dtype=np.int32)
    cj, snj = j_layers.rope_freqs(jnp.asarray(pos), 32, 1e6)
    ct, snt = t_layers.rope_freqs(torch.from_numpy(pos), 32, 1e6)
    close(ct, cj, atol=1e-6)
    close(snt, snj, atol=1e-6)
    close(t_layers.apply_rope(xt, ct, snt), j_layers.apply_rope(xj, cj, snj), atol=1e-6)


@pytest.mark.parametrize("S,chunk", [(48, 16), (40, 16), (40, 64)])
def test_chunked_ce_loss_equals_reference(S, chunk):
    rng = np.random.default_rng(S + chunk)
    xj, xt = _both(_normal(rng, (2, S, 32)))
    hj, ht = _both(_normal(rng, (32, 100), 0.2))
    labels = rng.integers(0, 100, (2, S)).astype(np.int32)
    labels[:, ::5] = -1
    got = t_layers.chunked_ce_loss(xt, ht, torch.from_numpy(labels).long(), chunk)
    close(got, j_layers.chunked_ce_loss(xj, hj, jnp.asarray(labels), chunk), **F32)


# -------------------------------------------------------------- attention
def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [_both(_normal(rng, (B, S, n, hd))) for n in (H, KV, KV)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_chunked_attention_equals_reference(causal, H, KV):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(0, 2, 256, H, KV, 16)
    got = t_attn.chunked_attention(qt, kt, vt, causal=causal, chunk=64)
    close(got, jit(j_attn.chunked_attention, causal=causal, chunk=64)(qj, kj, vj), atol=2e-5)
    close(got, t_attn.reference_attention(qt, kt, vt, causal=causal), atol=2e-5)


@pytest.mark.parametrize("window", [32, 64, 100])
def test_sliding_window_attention_equals_reference(window):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, 1, 256, 4, 2, 16)
    got = t_attn.chunked_attention(qt, kt, vt, causal=True, window=window, chunk=64)
    close(got, jit(j_attn.chunked_attention, causal=True, window=window, chunk=64)(qj, kj, vj), atol=2e-5)
    close(got, jit(j_attn.reference_attention, causal=True, window=window)(qj, kj, vj), atol=2e-5)


@pytest.mark.parametrize("chunk", [32, 128, 256])
def test_attention_chunk_sizes_equal_reference(chunk):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(4, 1, 256, 2, 2, 8)
    got = t_attn.chunked_attention(qt, kt, vt, causal=True, chunk=chunk)
    close(got, jit(j_attn.chunked_attention, causal=True, chunk=chunk)(qj, kj, vj), atol=2e-5)
    close(got, t_attn.chunked_attention(qt, kt, vt, causal=True, chunk=256), atol=2e-5)


def test_bf16_probability_attention_equals_reference():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(5, 2, 128, 8, 2, 32)
    bf = lambda j, t: (j.astype(jnp.bfloat16), t.to(torch.bfloat16))
    (qj, qt), (kj, kt), (vj, vt) = bf(qj, qt), bf(kj, kt), bf(vj, vt)
    got = t_attn.chunked_attention(qt, kt, vt, causal=True, window=48, chunk=32, p_dtype=torch.bfloat16)
    want = jit(j_attn.chunked_attention, causal=True, window=48, chunk=32,
               p_dtype=jnp.bfloat16)(qj, kj, vj)
    assert got.dtype == torch.bfloat16
    close(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_repeat_attention_pair_equals_reference(causal):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(6, 2, 128, 8, 2, 16)
    got = t_attn.chunked_attention_repeat(qt, kt, vt, causal=causal, window=40, chunk=32)
    close(got, jit(j_attn.chunked_attention_repeat, causal=causal, window=40, chunk=32)(qj, kj, vj), atol=2e-5)
    close(got, t_attn.chunked_attention(qt, kt, vt, causal=causal, window=40, chunk=32), atol=2e-5)


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("pos", [0, 37, 95])
def test_decode_attention_equals_reference(window, pos):
    rng = np.random.default_rng(pos + window)
    qj, qt = _both(_normal(rng, (2, 8, 16)))
    kj, kt = _both(_normal(rng, (2, 96, 2, 16)))
    vj, vt = _both(_normal(rng, (2, 96, 2, 16)))
    got = t_attn.decode_attention(qt, kt, vt, pos, window=window)
    close(got, j_attn.decode_attention(qj, kj, vj, jnp.int32(pos), window=window), atol=2e-5)
    close(t_attn.decode_attention_repeat(qt, kt, vt, pos, window=window),
          j_attn.decode_attention_repeat(qj, kj, vj, jnp.int32(pos), window=window), atol=2e-5)


def test_update_kv_cache_writes_in_place_at_pos():
    rng = np.random.default_rng(7)
    kj, kt = _both(_normal(rng, (2, 10, 2, 4)))
    vj, vt = _both(_normal(rng, (2, 10, 2, 4)))
    nkj, nkt = _both(_normal(rng, (2, 2, 4)))
    nvj, nvt = _both(_normal(rng, (2, 2, 4)))
    k_out, v_out = t_attn.update_kv_cache(kt, vt, nkt, nvt, 6)
    assert k_out.data_ptr() == kt.data_ptr() and v_out.data_ptr() == vt.data_ptr()
    kw, vw = j_attn.update_kv_cache(kj, vj, nkj, nvj, jnp.int32(6))
    assert np.array_equal(_np(k_out), _np(kw)) and np.array_equal(_np(v_out), _np(vw))


# -------------------------------------------------------------------- moe
@pytest.mark.parametrize("arch,cf", [("olmoe-1b-7b", 1.25), ("olmoe-1b-7b", 8.0),
                                     ("mixtral-8x22b", 1.25), ("mixtral-8x22b", 8.0)])
def test_moe_equals_reference(arch, cf):
    jcfg = dataclasses.replace(j_get_arch(arch).reduced(), capacity_factor=cf)
    tcfg = _t_cfg(jcfg)
    jp = jax.jit(functools.partial(j_tree_init, j_moe.moe_specs(jcfg)))(jax.random.PRNGKey(21))
    tp = _torch_tree(jp)
    xj, xt = _both(_normal(np.random.default_rng(22), (2, 32, jcfg.d_model)))
    out, aux = t_moe.moe_apply(tp, tcfg, xt)
    out_j, aux_j = jit(j_moe.moe_apply, cfg=jcfg)(jp, x=xj)
    close(out, out_j, atol=2e-4, rtol=1e-3)
    close(aux, aux_j, atol=2e-4, rtol=1e-3)
    dense = t_moe.moe_apply_dense_eval(tp, tcfg, xt)
    close(dense, jit(j_moe.moe_apply_dense_eval, cfg=jcfg)(jp, x=xj), atol=2e-4, rtol=1e-3)
    if cf == 8.0:  # ample capacity: no drops, the dispatch equals the dense oracle
        close(out, dense, atol=2e-4, rtol=1e-3)
    assert t_moe.capacity(tcfg, 32) == j_moe.capacity(jcfg, 32)


# -------------------------------------------------------------------- ssm
@pytest.fixture(scope="module")
def mamba1():
    jcfg = j_get_arch("falcon-mamba-7b").reduced()
    jp = jax.jit(functools.partial(j_tree_init, j_ssm.mamba1_specs(jcfg)))(jax.random.PRNGKey(7))
    return jcfg, _t_cfg(jcfg), jp, _torch_tree(jp)


@pytest.fixture(scope="module")
def mamba2():
    jcfg = j_get_arch("zamba2-2.7b").reduced()
    jp = jax.jit(functools.partial(j_tree_init, j_ssm.mamba2_specs(jcfg)))(jax.random.PRNGKey(11))
    return jcfg, _t_cfg(jcfg), jp, _torch_tree(jp)


def _torch_tree(jp):
    out = {}
    for k, v in jp.items():
        t = torch.from_numpy(np.array(v, np.float32))
        out[k] = t.to(torch.bfloat16) if v.dtype == jnp.bfloat16 else t
    return out


def test_causal_conv_and_segsum_equal_reference():
    rng = np.random.default_rng(9)
    xj, xt = _both(_normal(rng, (2, 20, 12)))
    wj, wt = _both(_normal(rng, (4, 12)))
    bj, bt = _both(_normal(rng, (12,)))
    close(t_ssm._causal_conv(xt, wt, bt), j_ssm._causal_conv(xj, wj, bj), atol=1e-6, rtol=1e-6)
    aj, at = _both(-np.abs(_normal(rng, (2, 3, 16))))
    got, want = t_ssm._segsum(at), j_ssm._segsum(aj)
    assert np.array_equal(np.isinf(_np(got)), np.isinf(_np(want)))
    finite = ~np.isinf(_np(want))
    np.testing.assert_allclose(_np(got)[finite], _np(want)[finite], atol=1e-6)


def test_mamba1_core_equals_reference(mamba1):
    jcfg, tcfg, jp, tp = mamba1
    rng = np.random.default_rng(8)
    xj, xt = _both(_normal(rng, (2, 96, jcfg.d_inner)))
    hj, ht = _both(_normal(rng, (2, jcfg.d_inner, jcfg.ssm_state), 0.1))
    y, h = t_ssm._mamba1_core(tp, tcfg, xt, ht)
    y_j, h_j = jit(j_ssm._mamba1_core, cfg=jcfg)(jp, x=xj, h0=hj)
    close(y, y_j, **F32)
    close(h, h_j, **F32)


@pytest.mark.parametrize("block", ["mamba1", "mamba2"])
def test_mamba_forward_and_decode_equal_reference(block, request):
    jcfg, tcfg, jp, tp = request.getfixturevalue(block)
    fwd = {"mamba1": (j_ssm.mamba1_forward, t_ssm.mamba1_forward),
           "mamba2": (j_ssm.mamba2_forward, t_ssm.mamba2_forward)}[block]
    dec = {"mamba1": (j_ssm.mamba1_decode, t_ssm.mamba1_decode),
           "mamba2": (j_ssm.mamba2_decode, t_ssm.mamba2_decode)}[block]
    B, S = 2, 64
    uj, ut = _both(_normal(np.random.default_rng(13), (B, S, jcfg.d_model)))
    y, h_last = fwd[1](tp, tcfg, ut)
    y_j, h_last_j = jit(fwd[0], cfg=jcfg)(jp, u=uj)
    close(y, y_j, **F32)
    close(h_last, h_last_j, **F32)

    if block == "mamba1":
        h_shape, conv_w = (B, jcfg.d_inner, jcfg.ssm_state), jcfg.d_inner
    else:
        h_shape, conv_w = (B, jcfg.ssm_nheads, jcfg.ssm_head_dim, jcfg.ssm_state), jcfg.d_inner + 2 * jcfg.ssm_state
    hj, ht = jnp.zeros(h_shape, jnp.float32), torch.zeros(h_shape)
    cj, ct = jnp.zeros((B, jcfg.ssm_conv - 1, conv_w)), torch.zeros((B, jcfg.ssm_conv - 1, conv_w))
    step_j = jax.jit(lambda u, h, c: dec[0](jp, jcfg, u, h, c))
    for t in range(12):
        yt, ht, ct = dec[1](tp, tcfg, ut[:, t], ht, ct)
        yj, hj, cj = step_j(uj[:, t], hj, cj)
        close(yt, yj, **F32)
        close(ht, hj, **F32)
        close(yt, y[:, t], atol=1e-4, rtol=1e-3)  # decode == forward, as the reference holds


def test_mamba2_core_equals_reference(mamba2):
    jcfg, tcfg, _, _ = mamba2
    B, S, H, P, N = 2, 64, jcfg.ssm_nheads, jcfg.ssm_head_dim, jcfg.ssm_state
    rng = np.random.default_rng(12)
    dt = np.log1p(np.exp(_normal(rng, (B, S, H))))
    A = -np.exp(_normal(rng, (H,)))
    ins = [_both(a) for a in (dt, A, _normal(rng, (B, S, N)), _normal(rng, (B, S, N)),
                               _normal(rng, (B, S, H, P)), _normal(rng, (B, H, P, N), 0.1))]
    y, h = t_ssm._mamba2_core(tcfg, *[t for _, t in ins])
    y_j, h_j = jax.jit(lambda *a: j_ssm._mamba2_core(jcfg, *a))(*[j for j, _ in ins])
    close(y, y_j, **F32)
    close(h, h_j, **F32)


# -------------------------------------------------------- whole models
def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        return {"frame_embeds": _normal(rng, (B, S, cfg.d_model), 1.0),
                "mask": rng.random((B, S)) < 0.3,
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        si = S // 2
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S - si)).astype(np.int32),
                "patch_embeds": _normal(rng, (B, si, cfg.d_model), 1.0),
                "labels": rng.integers(0, cfg.vocab_size, (B, S - si)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


N_DECODE = 16


def _grow_j(cache, n):
    return {k: jnp.pad(v, [(0, 0)] * (v.ndim - 3) + [(0, n), (0, 0), (0, 0)]) if k in ("k", "v") else v
            for k, v in cache.items()}


def _grow_t(cache, n):
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n)) if k in ("k", "v") else v
            for k, v in cache.items()}


def _run_both(jcfg, seed=0):
    """Prefill, a 16-step decode chain and the loss forward, through both
    packages on the same weights and inputs. One JIT (the JAX decode step)."""
    jm = j_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = _port_of(jm, jp)
    B, S = 2, 32
    batch = _batch(jcfg, B, S, seed)
    prompt = {k: v for k, v in batch.items() if k in ("tokens", "patch_embeds", "frame_embeds")}
    out = {"prefill": (tm.prefill(prompt), jax.jit(jm.prefill)(jp, {k: jnp.asarray(v) for k, v in prompt.items()})),
           "loss": (tm.loss(batch), jax.jit(jm.loss)(jp, {k: jnp.asarray(v) for k, v in batch.items()}))}
    if jcfg.has_decode:
        (_, t_cache), (_, j_cache) = out["prefill"]
        # the port's decode writes its cache in place: keep the prefill's apart
        t_cache = _grow_t({k: v.clone() for k, v in t_cache.items()}, N_DECODE)
        j_cache = _grow_j(j_cache, N_DECODE)
        toks = np.random.default_rng(seed + 1).integers(0, jcfg.vocab_size, (N_DECODE, B)).astype(np.int32)
        step = jax.jit(jm.decode_step)
        chain = []
        P = _prompt_len(prompt)
        for i in range(N_DECODE):
            lt, t_cache = tm.decode_step(toks[i], t_cache, P + i)
            lj, j_cache = step(jp, jnp.asarray(toks[i]), j_cache, jnp.int32(P + i))
            chain.append((lt, lj))
        out["decode"] = chain
        out["cache"] = (t_cache, j_cache)
    return out


def _prompt_len(prompt):
    return sum(v.shape[1] for k, v in prompt.items() if k in ("tokens", "patch_embeds"))


@pytest.fixture(scope="module", params=ARCHS)
def arch_run(request):
    return request.param, _run_both(j_get_arch(request.param).reduced())


def test_prefill_equals_reference(arch_run):
    arch, run = arch_run
    (t_logits, t_cache), (j_logits, j_cache) = run["prefill"]
    assert tuple(t_logits.shape) == tuple(j_logits.shape)
    close(t_logits, j_logits, **F32)
    assert set(t_cache) == set(j_cache)
    for name in j_cache:
        assert tuple(t_cache[name].shape) == tuple(j_cache[name].shape), name
        close(t_cache[name], j_cache[name], **F32)


def test_decode_chain_equals_reference(arch_run):
    arch, run = arch_run
    if "decode" not in run:
        assert not j_get_arch(arch).has_decode
        return
    for i, (lt, lj) in enumerate(run["decode"]):
        close(lt, lj, **F32, err_msg=f"step {i}")
    t_cache, j_cache = run["cache"]
    for name in j_cache:
        close(t_cache[name], j_cache[name], **F32)


def test_loss_equals_reference(arch_run):
    arch, run = arch_run
    (t_loss, t_m), (j_loss, j_m) = run["loss"]
    close(t_loss, j_loss, **F32)
    close(t_m["ce"], j_m["ce"], **F32)
    close(t_m["aux"], j_m["aux"], **F32)
    assert math.isfinite(float(t_loss.detach()))


@pytest.mark.parametrize("variant", ["bfloat16", "repeat_kv"])
def test_dense_variant_equals_reference(variant):
    """qwen2-0.5b reduced in bf16 activations (bf16 attention probabilities,
    3e-2) and with the repeat-KV attention A/B pair (f32, 1e-4)."""
    base = j_get_arch("qwen2-0.5b").reduced()
    if variant == "bfloat16":
        jcfg, tol = dataclasses.replace(base, dtype="bfloat16"), dict(atol=3e-2, rtol=3e-2)
    else:
        jcfg, tol = dataclasses.replace(base, attn_grouped=False), F32
    run = _run_both(jcfg, seed=2)
    (t_logits, _), (j_logits, _) = run["prefill"]
    close(t_logits, j_logits, **tol)
    for lt, lj in run["decode"]:
        close(lt, lj, **tol)
    close(run["loss"][0][0], run["loss"][1][0], **tol)
