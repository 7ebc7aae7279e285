"""The port's training plane (``repro_torch.training``) against the JAX
package's ``repro.training``, on the CPU, from numpy seeds.

Tolerances, set beforehand: ``adamw_update``, ``clip_by_global_norm`` and
``cosine_schedule`` within 1e-6 relative (f32, the same order of
operations); both data pipelines' batches **equal**; checkpoints restore
across the packages leaf for leaf, bit for bit (bf16 included); the
port's remat policies give **equal** gradients; 2 microbatches equal 1
within 1e-5 on the loss. Gradients and 3-step trajectories of every
family: ``tests/test_torch_train_families.py``.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.registry import get_arch as j_get_arch
from repro.distributed.compression import CompressionState as JCompressionState
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.models.spec import tree_init as j_tree_init
from repro.training import CheckpointManager as JCheckpointManager
from repro.training import SyntheticTokenPipeline as JSyntheticTokenPipeline
from repro.training import cosine_schedule as j_cosine_schedule
from repro.training import make_train_step as j_make_train_step
from repro.training import train_state_init as j_train_state_init
from repro.training import optimizer as j_opt
from repro.training.checkpoint import _flatten_with_paths as j_flatten_with_paths
from repro.training.data import DeidImagePipeline as JDeidImagePipeline
from repro_torch.carry import train_state_from_numpy
from repro_torch.config import model as t_config
from repro_torch.config.registry import get_arch as t_get_arch
from repro_torch.models import build_model as t_build_model
from repro_torch.models import moe as t_moe
from repro_torch.training import CheckpointManager, SyntheticTokenPipeline, cosine_schedule
from repro_torch.training import make_train_step, train_state_init
from repro_torch.training import optimizer as t_opt
from repro_torch.training.checkpoint import flatten_with_paths
from repro_torch.training.data import DeidImagePipeline
from repro_torch.training.train_step import TrainState
from torch_train import as_np as _np, assert_master_close, one_thread  # noqa: F401 (autouse fixture)

F32 = dict(atol=1e-4, rtol=1e-4)



def _t_cfg(jcfg):
    return t_config.ModelConfig(**dataclasses.asdict(jcfg))


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (bf16 as uint16), to compare restores exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.uint16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _pair(arch, seed=0, compression=False):
    """A reduced config's reference model and state, and the port's model and
    state carrying the same values."""
    jcfg = j_get_arch(arch).reduced()
    jm = j_build_model(jcfg)
    js = jax.jit(lambda key: j_train_state_init(jm, key, compression=compression))(jax.random.PRNGKey(seed))
    tm = t_build_model(_t_cfg(jcfg), "cpu")
    ts = train_state_from_numpy(train_state_init(tm, compression=compression), jax.tree.map(np.asarray, js))
    return jcfg, jm, js, tm, ts


# ------------------------------------------------------------- optimizer
def _tree(rng, dtype=np.float32):
    return {"b": {"w": rng.standard_normal((6, 5)).astype(dtype)}, "a": rng.standard_normal((7,)).astype(dtype)}


def _j_tree(tree, dtype=jnp.float32):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _t_tree(tree, dtype=torch.float32):
    return t_opt.tree_map(lambda x: torch.from_numpy(np.array(x)).to(dtype), tree)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_equals_reference(max_norm):
    g = _tree(np.random.default_rng(0))
    cj, nj = j_opt.clip_by_global_norm(_j_tree(g, jnp.bfloat16), max_norm)
    ct, nt = t_opt.clip_by_global_norm(_t_tree(g, torch.bfloat16), max_norm)
    np.testing.assert_allclose(_np(nt), _np(nj), rtol=1e-6)
    for k in ("a",):
        assert ct[k].dtype == torch.float32
        np.testing.assert_allclose(_np(ct[k]), _np(cj[k]), rtol=1e-6)
    np.testing.assert_allclose(_np(ct["b"]["w"]), _np(cj["b"]["w"]), rtol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_update_chain_equals_reference(weight_decay):
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    sj = j_opt.adamw_init(_j_tree(p0, jnp.bfloat16))
    st = t_opt.adamw_init(_t_tree(p0, torch.bfloat16))
    for i in range(5):
        g = _tree(rng)
        lr = np.float32(1e-3 * (i + 1))
        pj, sj = j_opt.adamw_update(_j_tree(g, jnp.bfloat16), sj, jnp.float32(lr), weight_decay=weight_decay)
        pt, st = t_opt.adamw_update(_t_tree(g, torch.bfloat16), st, torch.tensor(lr),
                                    weight_decay=weight_decay)
        assert int(st.step) == int(sj.step) == i + 1 and st.step.dtype == torch.int32
        for name in ("m", "v", "master"):
            for a, b in zip(t_opt.tree_leaves(getattr(st, name)), jax.tree.leaves(getattr(sj, name))):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-9, err_msg=f"{name} step {i}")
        for a, b in zip(t_opt.tree_leaves(pt), jax.tree.leaves(pj)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-2)  # one bf16 ulp at most


def test_adamw_reduces_quadratic():
    params = {"w": torch.ones(8, dtype=torch.bfloat16) * 2.0}
    st = t_opt.adamw_init(params)
    for _ in range(200):
        params, st = t_opt.adamw_update({"w": st.master["w"]}, st, torch.tensor(0.05), weight_decay=0.0)
    assert float(st.master["w"].abs().max()) < 0.3


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (5, 5), (20, 12)])
def test_cosine_schedule_equals_reference(warmup, total):
    fj, ft = j_cosine_schedule(3e-4, warmup, total), cosine_schedule(3e-4, warmup, total)
    for s in list(range(0, total + 3)):
        want = float(fj(jnp.int32(s)))
        got = ft(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        # 1e-6 of the peak: near the end 1 + cos(pi t) cancels, and one f32
        # ulp of the two libraries' cos is ~2e-5 of the value there
        assert math.isclose(float(got), want, rel_tol=1e-6, abs_tol=1e-6 * 3e-4), (s, float(got), want)


def test_tree_leaves_follow_jax_order():
    tree = {"z": 1, "a": {"y": 2, "b": 3}, "m": 4}
    assert t_opt.tree_leaves(tree) == jax.tree.leaves(tree)
    assert t_opt.tree_unflatten(tree, t_opt.tree_leaves(tree)) == tree


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llava-next-34b", "hubert-xlarge"])
def test_synthetic_pipeline_equals_reference(arch):
    jcfg = j_get_arch(arch).reduced()
    for host in (0, 1):
        pj = JSyntheticTokenPipeline(jcfg, 3, 40, seed=7, host_index=host, host_count=2)
        pt = SyntheticTokenPipeline(_t_cfg(jcfg), 3, 40, seed=7, host_index=host, host_count=2)
        for step in (0, 5):
            bj, bt = pj.get_batch(step), pt.get_batch(step)
            assert set(bj) == set(bt)
            for k in bj:
                assert bt[k].dtype == bj[k].dtype and np.array_equal(bt[k], bj[k]), (arch, k)
    it = iter(SyntheticTokenPipeline(_t_cfg(jcfg), 2, 16, seed=1))
    assert np.array_equal(next(it)["labels"], JSyntheticTokenPipeline(jcfg, 2, 16, seed=1).get_batch(0)["labels"])


def test_deid_image_pipeline_equals_reference():
    from repro_torch.dicom.generator import StudyGenerator

    jcfg = j_get_arch("llava-next-34b").reduced()
    gen = StudyGenerator(3)
    datasets = gen.gen_study("P0", modality="US", n_images=2).datasets + \
        gen.gen_study("P1", modality="CT", n_images=1).datasets
    pj, pt = JDeidImagePipeline(jcfg, seed=3), DeidImagePipeline(_t_cfg(jcfg), seed=3)
    assert np.array_equal(pt.proj, pj.proj)
    bj = pj.batch_from_datasets(datasets, batch=4, seq=64, rng=np.random.default_rng(0))
    bt = pt.batch_from_datasets(datasets, batch=4, seq=64, rng=np.random.default_rng(0))
    for k in bj:
        assert bt[k].dtype == bj[k].dtype and np.array_equal(bt[k], bj[k]), k


# ------------------------------------------------------------ checkpoint
def test_train_state_keys_equal_reference():
    jcfg, jm, js, tm, ts = _pair("qwen2-0.5b", compression=True)
    jkeys = list(j_flatten_with_paths(js)[0])
    tkeys = list(flatten_with_paths(ts))
    assert tkeys == jkeys and len(tkeys) == 71
    for key in (".params/embed/tok", ".opt/.step", ".opt/.m/layers/attn/wq", ".comp/layers/attn/bq/.residual"):
        assert key in tkeys


def test_checkpoint_written_by_reference_restores_in_port(tmp_path):
    jcfg, jm, js, tm, _ = _pair("falcon-mamba-7b", seed=3, compression=True)
    # a step, so the opt state is not trivially zero and A_log is bf16 (as
    # the reference's AdamW casts every parameter)
    step = jax.jit(j_make_train_step(jm, j_cosine_schedule(1e-3, 0, 10), compression=True))
    js, _ = step(js, jax.tree.map(jnp.asarray, JSyntheticTokenPipeline(jcfg, 2, 32, seed=0).get_batch(0)))
    JCheckpointManager(tmp_path, keep_n=2).save(4, js, extra={"tokens_seen": 64})
    # the template: a port state of other weights, stepped once so its
    # dtypes are a stepped state's
    fresh = t_build_model(_t_cfg(jcfg), "cpu", generator=torch.Generator().manual_seed(9))
    template, _ = make_train_step(fresh, cosine_schedule(1e-3, 0, 10), compression=True)(
        train_state_init(fresh, compression=True), SyntheticTokenPipeline(_t_cfg(jcfg), 2, 32, seed=1).get_batch(0))
    restored, step_n, extra = CheckpointManager(tmp_path).restore(template)
    assert step_n == 4 and extra == {"tokens_seen": 64}
    jflat = j_flatten_with_paths(js)[0]
    tflat = flatten_with_paths(restored)
    assert list(tflat) == list(jflat)
    for key, leaf in tflat.items():
        assert str(leaf.dtype).removeprefix("torch.") == np.asarray(jflat[key]).dtype.name, key
        assert np.array_equal(_bits(leaf), _bits(jflat[key])), key
    assert restored.params["layers"]["mamba"]["A_log"] is fresh.layers.mamba.A_log  # in place
    assert fresh.layers.mamba.A_log.dtype == torch.bfloat16


def test_checkpoint_written_by_port_restores_in_reference(tmp_path):
    jcfg, jm, js, tm, ts = _pair("olmoe-1b-7b", seed=4, compression=True)
    step = make_train_step(tm, cosine_schedule(1e-3, 0, 10), compression=True)
    ts, _ = step(ts, SyntheticTokenPipeline(_t_cfg(jcfg), 2, 32, seed=0).get_batch(0))
    CheckpointManager(tmp_path).save(1, ts, extra={"arch": jcfg.name})
    meta = json.loads((tmp_path / "step_00000001" / "meta.json").read_text())
    assert meta["dtypes"][".params/embed/tok"] == "bfloat16" and meta["dtypes"][".opt/.step"] == "int32"
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as npz:
        assert npz[".params/embed/tok"].dtype == np.uint16  # raw bits
    template = jax.tree.map(lambda x: x, js)
    template = template._replace(params=jax.tree.map(lambda x: x.astype(jnp.bfloat16), template.params))
    restored, step_n, extra = JCheckpointManager(tmp_path).restore(template)
    assert step_n == 1 and extra == {"arch": jcfg.name}
    tflat = flatten_with_paths(ts)
    for key, leaf in j_flatten_with_paths(restored)[0].items():
        assert np.array_equal(_bits(leaf), _bits(tflat[key])), key


def test_checkpoint_roundtrip_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=2)
    state = {"w": torch.ones(3), "b": torch.arange(4, dtype=torch.int32)}
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    for s in (1, 2, 3):
        mgr.save(s, {"w": state["w"] * s, "b": state["b"]})
    names = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert names == ["step_00000002", "step_00000003"] and mgr.latest_step() == 3
    restored, step, _ = mgr.restore(state)
    assert step == 3 and torch.equal(restored["w"], torch.full((3,), 3.0))
    older, _, _ = mgr.restore(state, step=2)
    assert torch.equal(older["w"], torch.full((3,), 2.0))
    # the reference reads the port's layout and keeps the same retention
    assert JCheckpointManager(tmp_path).latest_step() == 3


def test_mismatched_template_rejected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"w": torch.ones(4)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"v": torch.ones(3)})
    mgr.save(2, {"w": torch.ones(3, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        mgr.restore({"w": torch.ones(3)})
    # and the reference refuses the port's checkpoint on the same grounds
    with pytest.raises(ValueError):
        JCheckpointManager(tmp_path).restore({"w": jnp.ones((3,), jnp.float32)})


def test_train_state_from_numpy_checks_every_leaf():
    jcfg, jm, js, tm, ts = _pair("qwen2-0.5b", seed=2)
    tree = jax.tree.map(np.asarray, js)
    before = tm.ln_f.detach().clone()
    bad_step = tree._replace(opt=tree.opt._replace(step=np.zeros((), np.int64)))
    with pytest.raises(ValueError, match=".opt/.step: dtype int64"):
        train_state_from_numpy(ts, bad_step)
    bad_shape = tree._replace(params={**tree.params, "ln_f": np.ones(7, tree.params["ln_f"].dtype)})
    with pytest.raises(ValueError, match=".params/ln_f: shape"):
        train_state_from_numpy(ts, bad_shape)
    with pytest.raises(ValueError, match="unknown.*comp"):
        train_state_from_numpy(ts, tree._replace(comp={"ln_f": JCompressionState(np.zeros(128, np.float32))}))
    with torch.no_grad():
        tm.ln_f.zero_()
    with pytest.raises(ValueError):
        train_state_from_numpy(ts, bad_shape)
    assert not tm.ln_f.any()  # nothing loaded on a refusal
    train_state_from_numpy(ts, tree)
    assert torch.equal(tm.ln_f, before)


# ------------------------------------------------------- remat, MoE, steps
def _grads(model, batch):
    for p in model.parameters():
        p.grad = None
    loss, _ = model.loss(batch)
    loss.backward()
    out = {n: p.grad.clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x22b", "falcon-mamba-7b", "zamba2-2.7b"])
def test_remat_policies_give_equal_grads(arch):
    base = t_get_arch(arch).reduced()
    batch = SyntheticTokenPipeline(base, 2, 32, seed=5).get_batch(0)
    runs = {}
    for policy in ("none", "dots", "full"):
        model = t_build_model(dataclasses.replace(base, remat=policy), "cpu",
                              generator=torch.Generator().manual_seed(0))
        runs[policy] = _grads(model, batch)
    for policy in ("dots", "full"):
        assert runs[policy][0] == runs["none"][0], policy
        for name, g in runs["none"][1].items():
            assert torch.equal(runs[policy][1][name], g), (policy, name)


def test_remat_keeps_less_for_backward():
    """``full`` and ``dots`` save less than ``none`` outside their layers;
    the backward pass of ``full`` recomputes the layers' matmuls, that of
    ``dots`` reuses them."""
    from torch.autograd.graph import saved_tensors_hooks
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    base = t_get_arch("qwen2-0.5b").reduced()
    batch = SyntheticTokenPipeline(base, 2, 128, seed=5).get_batch(0)
    saved, mm_in_backward = {}, {}
    for policy in ("none", "dots", "full"):
        model = t_build_model(dataclasses.replace(base, remat=policy), "cpu",
                              generator=torch.Generator().manual_seed(0))
        total = [0]

        def pack(t, total=total):
            total[0] += t.numel() * t.element_size()
            return t

        with saved_tensors_hooks(pack, lambda t: t):
            loss, _ = model.loss(batch)
        saved[policy] = total[0]
        with CountMM() as mode:
            loss.backward()
        mm_in_backward[policy] = mode.n
    assert saved["full"] < saved["none"] and saved["dots"] < saved["none"], saved
    assert mm_in_backward["full"] > mm_in_backward["dots"] == mm_in_backward["none"], mm_in_backward


def test_moe_spill_row_gradient_is_zero():
    """At a capacity that drops tokens, a token whose every choice lands on
    the spill row gets no gradient through the experts, as in the reference."""
    jcfg = dataclasses.replace(j_get_arch("olmoe-1b-7b").reduced(), capacity_factor=0.25)
    tcfg = _t_cfg(jcfg)
    jp = jax.jit(lambda k: j_tree_init(j_moe.moe_specs(jcfg), k))(jax.random.PRNGKey(3))
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16 if v.dtype == jnp.bfloat16
                                                              else torch.float32) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    r = np.random.default_rng(5).standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = t_moe.moe_apply(tp, tcfg, xt)
    (out * torch.from_numpy(r)).sum().backward()
    gj = jax.grad(lambda xx: jnp.sum(j_moe.moe_apply(jp, jcfg, xx)[0] * r))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), atol=2e-4, rtol=1e-3)
    # which tokens the dispatch drops entirely: recompute its slots
    _, _, expert_idx = t_moe._route(tp, tcfg, torch.from_numpy(x))
    C, k, E = t_moe.capacity(tcfg, 32), tcfg.experts_per_token, tcfg.n_experts
    onehot = torch.nn.functional.one_hot(expert_idx.reshape(2, 32 * k), E)
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)
    dropped = (pos >= C).reshape(2, 32, k).all(-1)
    assert dropped.any() and not dropped.all()
    assert not xt.grad[dropped].any()  # all-spill tokens: exactly zero
    assert not np.asarray(gj)[dropped.numpy()].any()
    assert not torch.equal(out[dropped], out[dropped] + 1) and not out[dropped].any()


def test_microbatches_equal_one_batch():
    cfg = t_get_arch("qwen2-0.5b").reduced()
    batch = SyntheticTokenPipeline(cfg, 4, 64, seed=3).get_batch(1)
    sched = cosine_schedule(1e-3, 0, 100)
    out = {}
    for n in (1, 2, 4):
        model = t_build_model(cfg, "cpu", generator=torch.Generator().manual_seed(1))
        state, m = make_train_step(model, sched, microbatches=n)(train_state_init(model), batch)
        out[n] = (float(m["loss"]), state.opt.master)
    for n in (2, 4):
        assert math.isclose(out[n][0], out[1][0], rel_tol=1e-5), (n, out[n][0], out[1][0])
        worst = max(float((a - b).abs().max()) for a, b in zip(t_opt.tree_leaves(out[n][1]),
                                                               t_opt.tree_leaves(out[1][1])))
        assert worst < 5e-3  # the reference's own bound: bf16 grads accumulated in f32


def test_microbatched_step_equals_reference():
    jcfg, jm, js, tm, ts = _pair("h2o-danube-1.8b", seed=6)
    batch = JSyntheticTokenPipeline(jcfg, 4, 64, seed=2).get_batch(0)
    js, mj = jax.jit(j_make_train_step(jm, j_cosine_schedule(1e-3, 0, 10), microbatches=2))(
        js, jax.tree.map(jnp.asarray, batch))
    ts, mt = make_train_step(tm, cosine_schedule(1e-3, 0, 10), microbatches=2)(ts, batch)
    np.testing.assert_allclose(_np(mt["loss"]), _np(mj["loss"]), **F32)
    np.testing.assert_allclose(_np(mt["gnorm"]), _np(mj["gnorm"]), rtol=1e-3)
    for a, b in zip(t_opt.tree_leaves(ts.opt.master), jax.tree.leaves(js.opt.master)):
        assert_master_close(a, b, 1e-3)


def test_loss_falls_on_fixed_batch_and_with_compression():
    cfg = t_get_arch("qwen2-0.5b").reduced()
    batch = SyntheticTokenPipeline(cfg, 4, 64, seed=3).get_batch(0)
    for compression in (False, True):
        model = t_build_model(cfg, "cpu")
        state = train_state_init(model, torch.Generator().manual_seed(2), compression=compression)
        assert (state.comp is not None) == compression
        step = make_train_step(model, cosine_schedule(3e-3, 5, 200), compression=compression)
        losses = []
        for _ in range(30):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] - 0.5, (compression, losses[0], losses[-1])
        assert int(m["step"]) == 30 and set(m) == {"loss", "gnorm", "lr", "step"}


def test_resume_equals_uninterrupted_run(tmp_path):
    cfg = t_get_arch("qwen2-0.5b").reduced()
    pipe = SyntheticTokenPipeline(cfg, 2, 32, seed=9)

    def run(model, state, lo, hi):
        step = make_train_step(model, cosine_schedule(1e-3, 0, 100))
        losses = []
        for i in range(lo, hi):
            state, m = step(state, pipe.get_batch(i))
            losses.append(float(m["loss"]))
        return state, losses

    ma = t_build_model(cfg, "cpu")
    sa, la = run(ma, train_state_init(ma, torch.Generator().manual_seed(5)), 0, 6)
    mb = t_build_model(cfg, "cpu")
    sb, lb = run(mb, train_state_init(mb, torch.Generator().manual_seed(5)), 0, 3)
    CheckpointManager(tmp_path).save(3, sb)
    mc = t_build_model(cfg, "cpu", generator=torch.Generator().manual_seed(77))  # other weights
    restored, step, _ = CheckpointManager(tmp_path).restore(train_state_init(mc))
    assert step == 3
    for a, b in zip(flatten_with_paths(restored).values(), flatten_with_paths(sb).values()):
        assert np.array_equal(_bits(a), _bits(b))
    sc, lc = run(mc, restored, 3, 6)
    np.testing.assert_allclose(lb + lc, la, rtol=1e-6)
    for a, b in zip(t_opt.tree_leaves(sa.opt.master), t_opt.tree_leaves(sc.opt.master)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def test_f32_leaves_become_bf16_after_a_step_in_both_packages(tmp_path):
    """The reference's AdamW casts every parameter to bf16, the f32-specified
    SSM leaves too; the port follows it, so a resume of such a state into a
    fresh (f32) template raises in both (ROADMAP §3)."""
    jcfg, jm, js, tm, ts = _pair("falcon-mamba-7b", seed=1)
    assert js.params["layers"]["mamba"]["A_log"].dtype == jnp.float32
    assert ts.params["layers"]["mamba"]["A_log"].dtype == torch.float32
    batch = JSyntheticTokenPipeline(jcfg, 2, 32, seed=0).get_batch(0)
    js, _ = jax.jit(j_make_train_step(jm, j_cosine_schedule(1e-3, 0, 10)))(js, jax.tree.map(jnp.asarray, batch))
    ts, _ = make_train_step(tm, cosine_schedule(1e-3, 0, 10))(ts, batch)
    assert js.params["layers"]["mamba"]["A_log"].dtype == jnp.bfloat16
    assert tm.layers.mamba.A_log.dtype == torch.bfloat16
    assert ts.opt.master["layers"]["mamba"]["A_log"].dtype == torch.float32
    CheckpointManager(tmp_path).save(1, ts)
    fresh = t_build_model(_t_cfg(jcfg), "cpu")
    with pytest.raises(ValueError, match="dtype mismatch"):
        CheckpointManager(tmp_path).restore(train_state_init(fresh))
    with pytest.raises(ValueError, match="dtype mismatch"):
        JCheckpointManager(tmp_path).restore(j_train_state_init(jm, jax.random.PRNGKey(0)))


def test_train_state_init_draws_like_build_model():
    cfg = t_get_arch("zamba2-2.7b").reduced()
    a = t_build_model(cfg, "cpu", generator=torch.Generator().manual_seed(4))
    b = t_build_model(cfg, "cpu")
    state = train_state_init(b, torch.Generator().manual_seed(4), compression=True)
    assert isinstance(state, TrainState)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert state.params["shared"]["attn"]["wq"] is b.shared.attn.wq
    assert not state.comp["shared"]["attn"]["wq"].residual.any()
