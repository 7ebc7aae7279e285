"""Helpers shared by the port's training tests (``test_torch_train*.py``):
the per-family run (``run_family``) and its checks, whose tolerances
``test_torch_train_families.py`` states."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.registry import get_arch as j_get_arch
from repro.models import build_model as j_build_model
from repro.training import SyntheticTokenPipeline as JSyntheticTokenPipeline
from repro.training import cosine_schedule as j_cosine_schedule
from repro.training import make_train_step as j_make_train_step
from repro.training import train_state_init as j_train_state_init
from repro.training.checkpoint import _flatten_with_paths as j_flatten_with_paths
from repro_torch.carry import train_state_from_numpy
from repro_torch.config import model as t_config
from repro_torch.models import build_model as t_build_model
from repro_torch.training import cosine_schedule, make_train_step, train_state_init
from repro_torch.training.checkpoint import flatten_with_paths


def as_np(x) -> np.ndarray:
    """A torch tensor or a JAX/numpy array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_master_close(got, want, lr_sum, what=""):
    """Master weights within 1e-4 (atol and rtol), except where AdamW's
    first steps, lr * m / sqrt(v) ~ lr * sign(g), met a gradient within
    rounding of zero and flipped its sign: at most 0.01 % of a leaf's
    elements, each within 2 * (the learning rates summed)."""
    got, want = as_np(got), as_np(want)
    err = np.abs(got - want)
    off = err > 1e-4 + 1e-4 * np.abs(want)
    assert off.sum() <= max(1, want.size // 10000), (what, int(off.sum()), want.size)
    assert (err <= 2 * lr_sum + 1e-4).all(), (what, float(err.max()))


STEPS = 3
LR, WARMUP, TOTAL = 1e-3, 1, 10


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def run_family(arch):
    """Everything the tests read, computed once per family."""
    jcfg = j_get_arch(arch).reduced()
    tcfg = t_config.ModelConfig(**dataclasses.asdict(jcfg))
    jm = j_build_model(jcfg)
    js = jax.jit(lambda key: j_train_state_init(jm, key))(jax.random.PRNGKey(0))
    tm = t_build_model(tcfg, "cpu")
    ts = train_state_from_numpy(train_state_init(tm), jax.tree.map(np.asarray, js))
    pipe = JSyntheticTokenPipeline(jcfg, 2, 32, seed=1)
    batch = pipe.get_batch(0)
    jbatch = jax.tree.map(jnp.asarray, batch)
    out = {}

    # gradients of the bf16 weights, as a train step takes them
    jg = j_flatten_with_paths(jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(js.params, jbatch))[0]
    tm.loss(batch)[0].backward()
    out["grads_bf16"] = {k: (as_np(p.grad), as_np(jg[k]), p.grad.dtype)
                         for k, p in flatten_with_paths(ts.params).items()}
    for p in tm.parameters():
        p.grad = None

    # gradients with the weights in f32
    j32 = jax.tree.map(lambda x: x.astype(jnp.float32), js.params)
    jg32 = j_flatten_with_paths(jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(j32, jbatch))[0]
    t32 = t_build_model(tcfg, "cpu")
    t32.load_state_dict(tm.state_dict())
    t32.float()
    t32.loss(batch)[0].backward()
    out["grads_f32"] = {k: (as_np(p.grad), as_np(jg32[k]))
                        for k, p in flatten_with_paths(t32.params()).items()}

    # train steps from the same state
    jstep = jax.jit(j_make_train_step(jm, j_cosine_schedule(LR, WARMUP, TOTAL)))
    tstep = make_train_step(tm, cosine_schedule(LR, WARMUP, TOTAL))
    metrics = []
    for i in range(STEPS):
        b = pipe.get_batch(i)
        js, mj = jstep(js, jax.tree.map(jnp.asarray, b))
        ts, mt = tstep(ts, b)
        metrics.append({k: (float(mt[k]), float(mj[k])) for k in mt})
    out["metrics"] = metrics
    out["master"] = (flatten_with_paths(ts.opt.master), j_flatten_with_paths(js.opt.master)[0])
    out["params"] = (flatten_with_paths(ts.params), j_flatten_with_paths(js.params)[0])
    out["lr_sum"] = sum(m["lr"][1] for m in metrics)
    return out


def check_f32_grads(name, run):
    assert run["grads_f32"]
    for key, (got, want) in run["grads_f32"].items():
        assert np.isfinite(got).all(), key
        assert _rel(got, want) <= 1e-4, (name, key, _rel(got, want))


def check_bf16_grads(name, run):
    for key, (got, want, dtype) in run["grads_bf16"].items():
        assert _rel(got, want) <= 1e-3, (name, key, _rel(got, want))


def check_train_steps(name, run):
    for i, m in enumerate(run["metrics"]):
        np.testing.assert_allclose(*m["loss"], atol=1e-4, rtol=1e-4, err_msg=f"{name} loss step {i}")
        np.testing.assert_allclose(*m["gnorm"], rtol=1e-3, err_msg=f"{name} gnorm step {i}")
        np.testing.assert_allclose(*m["lr"], rtol=1e-6, err_msg=f"{name} lr step {i}")
        assert m["step"] == (i + 1, i + 1)
    got, want = run["master"]
    assert list(got) == list(want)
    for key in got:
        assert_master_close(got[key], want[key], run["lr_sum"], f"{name} {key}")
    # the new bf16 weights went into the model, dtype for dtype
    got_p, want_p = run["params"]
    for key, p in got_p.items():
        assert str(p.dtype).removeprefix("torch.") == np.asarray(want_p[key]).dtype.name, key


def check_loss_falls(name, run):
    losses = [m["loss"][0] for m in run["metrics"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], (name, losses)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while a training test module runs: its tensors are
    tiny, and several test workers share the cores, where a team of threads
    a worker spins and waits at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
