"""The port's LM serving path (``repro_torch.serving``, ``launch.serve``, the
``serve_lm`` example twin) against the JAX package's engine, on the CPU.

The port runs on the JAX ``init``'s weights (``model_params_from_numpy``).
Greedy tokens must be equal. Temperature sampling draws from a
``torch.Generator`` and is held to its own contract, not to JAX's bits.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.registry import get_arch as j_get_arch
from repro.models import build_model as j_build_model
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.carry import model_params_from_numpy
from repro_torch.config.registry import get_arch as t_get_arch
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model as t_build_model
from repro_torch.serving import BatchResult, Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
# dense, sliding window, MoE (top-2 of 8, top-2 of 8 fine-grained), SSM, hybrid
SERVE_ARCHS = ["qwen2-0.5b", "h2o-danube-1.8b", "mixtral-8x22b", "olmoe-1b-7b",
               "falcon-mamba-7b", "zamba2-2.7b"]
# two batches of 3 with the same prompt length (64) and horizon (12): one
# compile each of the reference's prefill and decode. h2o-danube's reduced
# window is 64, so its decode steps past position 64 drop the oldest keys.
PROMPT_LENS = [64, 17, 40, 33, 64, 8]
MAX_NEW = [12, 12, 5, 12, 7, 12]


def _models(arch, seed=0):
    jm = j_build_model(j_get_arch(arch).reduced())
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = t_build_model(t_get_arch(arch).reduced(), "cpu")
    model_params_from_numpy(tm, jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def _serve(engine, request_cls, prompts, max_new, **kw):
    for i, (prompt, m) in enumerate(zip(prompts, max_new)):
        engine.submit(request_cls(f"r{i}", prompt, max_new_tokens=m, **kw))
    return engine.run()


def _as_rows(results):
    return [(r.request_id, list(r.tokens), r.prompt_len) for r in results]


@pytest.fixture(scope="module", params=SERVE_ARCHS)
def served(request):
    arch = request.param
    jm, jp, tm = _models(arch)
    prompts = _prompts(jm.cfg.vocab_size, PROMPT_LENS, seed=len(arch))
    j_eng = JServeEngine(jm, jp, max_batch=3)
    t_eng = ServeEngine(tm, max_batch=3)
    return arch, (_serve(j_eng, JRequest, prompts, MAX_NEW), j_eng), (_serve(t_eng, Request, prompts, MAX_NEW), t_eng)


def test_greedy_tokens_equal_reference(served):
    arch, (j_res, _), (t_res, _) = served
    assert _as_rows(t_res) == _as_rows(j_res), arch
    assert all(isinstance(r, BatchResult) for r in t_res)
    assert [len(r.tokens) for r in t_res] == MAX_NEW


def test_decode_steps_equal_reference(served):
    arch, (_, j_eng), (_, t_eng) = served
    assert t_eng.steps_executed == j_eng.steps_executed == 2 * (max(MAX_NEW) - 1)


class _HeldCaches:
    """``Model._held_cache`` on the CPU, where the model holds none: every
    leaf of ``cache_specs`` (``k``, ``v``, an SSM state, a conv buffer) a
    (batch, horizon) shape, kept across batches and made full of NaN, so
    that a position or leaf the growth leaves unwritten poisons the step
    that reads it."""

    def __init__(self, model):
        self.model, self.held = model, {}

    def __call__(self, batch, P, total):
        if (batch, total) not in self.held:
            self.held[batch, total] = {n: torch.full(s.shape, float("nan"), dtype=s.dtype)
                                       for n, s in self.model.cache_specs(batch, total).items()}
        return self.held[batch, total]


def test_held_decode_cache_serves_as_fresh_engines(served, monkeypatch):
    """One engine serves two batches of one shape, then one of another, each
    grown into the decode cache held for its shape: every batch gives the
    tokens of a fresh engine on fresh caches and of the reference, in every
    family (an SSM's state and conv leaves are copied into the held ones).
    On the CPU the model itself holds no decode cache."""
    arch, (j_res, _), (_, t_eng) = served
    model = t_eng.model
    prompts = (_prompts(model.cfg.vocab_size, PROMPT_LENS, seed=len(arch))
               + _prompts(model.cfg.vocab_size, [9, 5, 7], seed=len(arch) + 1))
    max_new = MAX_NEW + [4, 4, 4]
    fresh = [r.tokens for i in range(0, len(prompts), 3)
             for r in _serve(ServeEngine(model, max_batch=3), Request, prompts[i:i + 3], max_new[i:i + 3])]
    assert model._held_cache(3, 9, 9 + 4) is None and not model._decode_graphs
    caches = _HeldCaches(model)
    monkeypatch.setattr(model, "_held_cache", caches)
    held = [r.tokens for r in _serve(ServeEngine(model, max_batch=3), Request, prompts, max_new)]
    assert held == fresh
    assert held[:len(j_res)] == [r.tokens for r in j_res]
    assert list(caches.held) == [(3, 64 + 12), (3, 9 + 4)]


def test_layered_held_decode_cache_serves_as_fresh_engines(monkeypatch):
    """The reduced granite stack (Mamba-2 and attention layers, dropless
    experts; no reference in the JAX package): one engine serves two batches
    of one shape, then one of another, through held decode caches, and gives
    the tokens of fresh engines; every step decodes in a held cache, whose
    every leaf was written (no NaN is left). On the CPU the model itself
    holds no decode cache."""
    from repro_torch.models.model import DECODE_GRAPH_MIN_NEW
    from test_torch_layered import CUT

    model = t_build_model(CUT.reduced(), "cpu", generator=torch.Generator().manual_seed(0))
    prompts = _prompts(model.cfg.vocab_size, PROMPT_LENS + [9, 5, 7], seed=11)
    max_new = MAX_NEW + [4, 4, 4]
    fresh = [r.tokens for i in range(0, len(prompts), 3)
             for r in _serve(ServeEngine(model, max_batch=3), Request, prompts[i:i + 3], max_new[i:i + 3])]
    assert model._held_cache(3, 9, 9 + DECODE_GRAPH_MIN_NEW) is None and not model._decode_graphs
    caches = _HeldCaches(model)
    monkeypatch.setattr(model, "_held_cache", caches)
    seen, decode = [], model.decode_step
    monkeypatch.setattr(model, "decode_step", lambda tok, cache, pos: seen.append(cache) or decode(tok, cache, pos))
    held = [r.tokens for r in _serve(ServeEngine(model, max_batch=3), Request, prompts, max_new)]
    assert held == fresh
    assert list(caches.held) == [(3, 64 + 12), (3, 9 + 4)]
    leaves = {id(t) for c in caches.held.values() for t in c.values()}
    assert seen and all(set(c) == {"ssm", "conv", "k", "v"} and {id(t) for t in c.values()} <= leaves
                        for c in seen)
    assert not any(t.isnan().any() for c in caches.held.values() for t in c.values())


def test_stop_token_and_step_equal_reference():
    jm, jp, tm = _models("qwen2-0.5b", seed=3)
    prompts = _prompts(jm.cfg.vocab_size, [9, 4, 6], seed=5)
    first = _serve(JServeEngine(jm, jp, max_batch=3), JRequest, prompts, [6, 6, 6])
    stop = first[1].tokens[1]  # a token the second row emits after its first
    j_eng = JServeEngine(jm, jp, max_batch=2, stop_token=stop)
    t_eng = ServeEngine(tm, max_batch=2, stop_token=stop)
    for eng, cls in ((j_eng, JRequest), (t_eng, Request)):
        for i, prompt in enumerate(prompts):
            eng.submit(cls(f"r{i}", prompt, max_new_tokens=6))
    # step() serves one batch at a time, and nothing once the queue is idle
    j_steps = [_as_rows(j_eng.step()) for _ in range(3)]
    t_steps = [_as_rows(t_eng.step()) for _ in range(3)]
    assert t_steps == j_steps
    assert [len(s) for s in t_steps] == [2, 1, 0]
    assert len(t_steps[0][1][1]) < 6 and t_steps[0][1][1][-1] == stop
    assert t_eng.steps_executed == j_eng.steps_executed


def test_temperature_sampling_is_seeded_and_greedy_rows_stay_greedy():
    tm = t_build_model(t_get_arch("qwen2-0.5b").reduced(), "cpu")
    prompts = _prompts(tm.cfg.vocab_size, [7, 7, 7], seed=9)

    def sample(seed, temps):
        eng = ServeEngine(tm, max_batch=3)
        for i, (prompt, t) in enumerate(zip(prompts, temps)):
            eng.submit(Request(f"r{i}", prompt, max_new_tokens=8, temperature=t))
        return [r.tokens for r in eng.run(torch.Generator().manual_seed(seed))]

    greedy = sample(0, [0.0, 0.0, 0.0])
    a, b, c = sample(1, [0.0, 1.5, 1.5]), sample(1, [0.0, 1.5, 1.5]), sample(2, [0.0, 1.5, 1.5])
    assert a == b  # the same generator seed gives the same samples
    assert a[0] == c[0] == greedy[0]  # a temperature-0 row is greedy
    assert a[1:] != c[1:] and a[1:] != greedy[1:]
    assert all(0 <= tok < tm.cfg.vocab_size for row in a for tok in row)


def _reference_greedy(jm, jp, prompts, max_new):
    """The engine's semantics built from the reference's own prefill and
    decode step, with only the K/V caches grown: the oracle where the
    reference engine's ``_grow_cache`` fails."""
    B, P = len(prompts), max(len(p) for p in prompts)
    toks = np.zeros((B, P), np.int32)
    for i, p in enumerate(prompts):
        toks[i, P - len(p):] = p
    logits, cache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    cache = {k: jnp.pad(v, [(0, 0)] * (v.ndim - 3) + [(0, max_new - 1), (0, 0), (0, 0)])
             if k in ("k", "v") else v for k, v in cache.items()}
    step = jax.jit(jm.decode_step)
    cur = np.asarray(jnp.argmax(logits, -1))
    out = [cur]
    for s in range(1, max_new):
        logits, cache = step(jp, jnp.asarray(cur, jnp.int32), cache, jnp.int32(P + s - 1))
        cur = np.asarray(jnp.argmax(logits, -1))
        out.append(cur)
    return np.stack(out, 1).tolist()


@pytest.mark.parametrize("arch,lens,max_batch,error", [
    # falcon-mamba: B == P matches the ssm (L, B, d_inner, N) and conv caches
    ("falcon-mamba-7b", [4, 4, 4, 4], 4, "Cannot concatenate"),
    # zamba2: its 8 SSM heads == P matches the ssm (G, A, B, H, P_head, N) cache
    ("zamba2-2.7b", [8, 6], 2, "incompatible shapes"),
])
def test_grow_cache_fault_reference_raises_port_serves(arch, lens, max_batch, error):
    """ROADMAP §3 item 6: the reference's ``_grow_cache`` pads every cache
    leaf whose shape[-3] equals the prompt length P; the port grows only the
    leaves whose spec has the ``cache_seq`` axis."""
    jm, jp, tm = _models(arch, seed=4)
    prompts = _prompts(jm.cfg.vocab_size, lens, seed=11)
    with pytest.raises(TypeError, match=error):
        _serve(JServeEngine(jm, jp, max_batch=max_batch), JRequest, prompts, [3] * len(prompts))
    port = [r.tokens for r in _serve(ServeEngine(tm, max_batch=max_batch), Request, prompts,
                                     [3] * len(prompts))]
    assert port == _reference_greedy(jm, jp, prompts, 3)
    if arch == "falcon-mamba-7b":  # at max_batch=2 (B != P) the reference runs
        ref2 = _serve(JServeEngine(jm, jp, max_batch=2), JRequest, prompts, [3] * len(prompts))
        port2 = _serve(ServeEngine(tm, max_batch=2), Request, prompts, [3] * len(prompts))
        assert [r.tokens for r in port2] == [r.tokens for r in ref2] == port


# a reduced config of every family (the layered one from ``test_torch_layered``)
GROW_ARCHS = {"dense": "qwen2-0.5b", "vlm": "llava-next-34b", "moe": "olmoe-1b-7b", "ssm": "falcon-mamba-7b",
              "hybrid": "zamba2-2.7b", "layered": None, "encoder": "hubert-xlarge"}


@pytest.mark.parametrize("held", [True, False], ids=["held", "fresh"])
@pytest.mark.parametrize("family", list(GROW_ARCHS))
def test_grow_cache_grows_the_cache_seq_axis(family, held, monkeypatch):
    """``Model.grow_cache`` on a prefill's cache, into the cache the model
    holds for the shape (still full of a longer batch's 7.0) or into
    ``init_cache``'s: a leaf whose spec has ``cache_seq`` takes the prompt
    in its first P positions along it and zeros after; every other leaf (an
    SSM state, a conv buffer) is copied whole; the batch is read along
    ``act_batch``. An encoder has no cache and asks for none."""
    if family == "layered":
        from test_torch_layered import CUT

        cfg = CUT.reduced()
    else:
        cfg = t_get_arch(GROW_ARCHS[family]).reduced()
    model = t_build_model(cfg, "cpu", generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    B, S = 3, 8
    if family == "encoder":
        batch = {"frame_embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(1, cfg.vocab_size, (B, S))}
    if family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    _, cache = model.prefill(batch)
    P = S + (8 if family == "vlm" else 0)
    total = P + 5
    asked, store = [], {}
    if held:
        store = {} if family == "encoder" else {n: torch.full(s.shape, 7.0, dtype=s.dtype)
                                                 for n, s in model.cache_specs(B, total).items()}
        monkeypatch.setattr(model, "_held_cache", lambda *a: asked.append(a) or store)
    grown = model.grow_cache(cache, P, total)
    if family == "encoder":
        assert cache == grown == {} and not asked
        return
    specs = model.cache_specs(B, total)
    assert set(grown) == set(cache) == set(specs)
    assert asked == ([(B, P, total)] if held else [])
    for name, t in cache.items():
        got, spec = grown[name], specs[name]
        assert (got.shape, got.dtype) == (spec.shape, spec.dtype), name
        assert got is store[name] if held else got is not t
        assert t.any(), name
        if "cache_seq" in spec.axes:
            seq = spec.axes.index("cache_seq")
            assert torch.equal(got.narrow(seq, 0, P), t), name
            assert not got.narrow(seq, P, total - P).any(), name
        else:
            assert torch.equal(got, t), name


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b"])
def test_launch_serve_on_cpu(arch):
    out = t_serve.main(["--arch", arch, "--requests", "3", "--max-new", "4", "--max-batch", "2",
                        "--device", "cpu"])
    assert out["requests"] == 3 and out["tokens"] == 12 and out["device"] == "cpu"


def test_launch_serve_refuses_an_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        t_serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_serve_lm_example_twin(capsys):
    spec = importlib.util.spec_from_file_location("serve_lm_torch", ROOT / "examples" / "serve_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--requests", "2", "--device", "cpu"])
    assert "served 2 requests / 24 tokens" in capsys.readouterr().out


def test_default_device_is_the_card():
    cfg = t_get_arch("qwen2-0.5b").reduced()
    if torch.cuda.is_available():
        assert t_build_model(cfg).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            t_build_model(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_serve.main(["--requests", "1"])
