"""The port's ``layered`` family (granitemoehybrid) on the CPU: its
configuration's counts, the dropless MoE against a per-expert loop where
the capacity path drops, the grouped GEMM against its plain version,
uninitialised parameters, and the attention scale's default left bit for
bit."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.config import get_arch
from repro_torch.config.model import LayeredConfig
from repro_torch.models import blocks, build_model, moe
from repro_torch.models.spec import param_count

CUT = LayeredConfig(
    name="granite-4.0-h-small", family="layered", n_layers=20, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=768, vocab_size=100352, head_dim=128, rope_theta=0.0, n_experts=72, experts_per_token=10,
    ssm_state=128, ssm_version=2, ssm_head_dim=64, ssm_chunk=256, tie_embeddings=True,
    layer_types=tuple(["mamba"] * 5 + ["attention"] + ["mamba"] * 9 + ["attention"] + ["mamba"] * 4),
    shared_d_ff=1536, embedding_multiplier=12.0, residual_multiplier=0.22, attn_scale=1 / 128,
    logits_scaling=16.0)


@pytest.mark.parametrize("cfg", [CUT.reduced(), CUT], ids=["reduced", "cut"])
def test_param_count_equals_the_tree(cfg):
    """The analytic count against the parameters the model registers (the
    cut at its published widths on ``meta``): 16,309,191,936 for the cut."""
    model = build_model(cfg, "cpu" if cfg is not CUT else "meta", generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() == param_count(model.param_specs())
    if cfg is CUT:
        assert cfg.param_count() == 16309191936
        assert cfg.active_param_count() == 16309191936 - 20 * 62 * 3 * 4096 * 768
        assert (cfg.n_mamba, cfg.n_attn, cfg.softmax_scale) == (18, 2, 1 / 128)
    assert cfg.reduced().layer_types == ("mamba", "attention", "mamba", "mamba")


def _routed_to_two(cfg, T):
    """Router weights and tokens that send every token to experts 1 and 5."""
    g = torch.Generator().manual_seed(7)
    d, E = cfg.d_model, cfg.n_experts
    p = {k: (torch.randn(s.shape, generator=g) * 0.05).to(s.dtype) for k, s in moe.moe_specs(cfg).items()}
    p["router"] = torch.zeros(d, E)
    p["router"][0, 1], p["router"][0, 5] = 4.0, 3.0
    x = torch.randn(1, T, d, generator=g)
    x[..., 0] = 1.0 + x[..., 0].abs()
    return p, x


def test_dropless_equals_a_loop_over_experts_where_capacity_drops():
    """Every token routes to experts 1 and 5: the capacity path keeps
    ``capacity`` of the T pairs an expert gets and drops the rest; the
    dropless path routes all and equals a plain loop over the experts on
    the tokens that chose each (float32, other summation orders: 1e-6)."""
    cfg = dataclasses.replace(CUT.reduced(), capacity_factor=1.25)
    T = 64
    p, x = _routed_to_two(cfg, T)
    probs, gates, idx = moe._route(p, cfg, x)
    assert set(idx.flatten().tolist()) == {1, 5}
    counters = moe.MoeCounters()
    with moe.counting(counters, "prefill"):
        capped, _ = moe.moe_apply(p, cfg, x)
        got = moe.moe_apply_dropless(p, cfg, x)
    dropped = counters.read()["moe_pairs_dropped"]
    assert dropped == 2 * (T - moe.capacity(cfg, T)) > 0
    want = torch.zeros(T, cfg.d_model)
    xt = x[0]
    for e in range(cfg.n_experts):
        tok, slot = torch.nonzero(idx[0] == e, as_tuple=True)
        if tok.numel():
            h = F.silu(xt[tok] @ p["gate"][e].float()) * (xt[tok] @ p["up"][e].float())
            want.index_add_(0, tok, (h @ p["down"][e].float()) * gates[0, tok, slot][:, None])
    torch.testing.assert_close(got[0], want, rtol=0, atol=1e-6)
    assert not torch.allclose(capped[0], want, atol=1e-3)
    c = counters.read()
    assert c["moe_pairs_routed"] == 2 * 2 * T and c["expert_gemm_calls"] == {"prefill": 3, "decode": 0}
    assert c["moe_max_expert_share"] == 0.5
    assert c["expert_tokens"] == {"prefill": T, "decode": 0} and c["experts_used"] == {"prefill": 2, "decode": 0}


def test_moe_counters_accumulate_in_place():
    """Three decode calls of the dropless path under ``counting(...,
    "decode")``: every counter is a device tensor that keeps the tensor the
    first call made (a step replayed from a CUDA graph adds into them) and
    reads the sum (the largest share: the maximum) of the calls counted one
    by one."""
    cfg = CUT.reduced()
    g = torch.Generator().manual_seed(3)
    p = {k: (torch.randn(s.shape, generator=g) * 0.05).to(s.dtype) for k, s in moe.moe_specs(cfg).items()}
    total, each = moe.MoeCounters(), []
    for i in range(3):
        x = torch.randn(4, cfg.d_model, generator=g)
        one = moe.MoeCounters()
        for c in (total, one):
            with moe.counting(c, "decode"):
                moe.moe_apply_dropless(p, cfg, x)
        each.append(one.read())
        held = dict(total.totals, max_share=total.max_share)
        if i == 0:
            first = held
        assert held.keys() == first.keys() and all(t is first[key] for key, t in held.items())
    assert set(first) == {"pairs_routed", "max_share"} | {(key, "decode") for key in
                                                          ("tokens", "gemm_calls", "experts_used")}
    got = total.read()
    assert got["moe_pairs_routed"] == sum(r["moe_pairs_routed"] for r in each) == 3 * 4 * cfg.experts_per_token
    assert got["moe_max_expert_share"] == max(r["moe_max_expert_share"] for r in each)
    for key in ("expert_gemm_calls", "expert_tokens", "experts_used"):
        assert got[key] == {"prefill": 0, "decode": sum(r[key]["decode"] for r in each)}, key
    assert got["expert_gemm_calls"]["decode"] == 9 and got["expert_tokens"]["decode"] == 12
    assert got["moe_pairs_dropped"] == 0


@pytest.mark.parametrize("counts", [[0, 5, 0, 17, 1, 0, 40, 3], [0] * 7 + [130], [1] * 72, [33, 32, 1],
                                    [1] * 4 + [0] * 68])
def test_grouped_mm_in_bf16_equals_the_plain_version(counts):
    """The library's grouped GEMM (bf16, here on the CPU) over ragged runs,
    empty experts among them, against the per-expert loop: both sum in
    float32 and round once to bf16, in other orders, so they may land one
    bf16 step apart (2^-8 of the value); rtol is two steps."""
    g = torch.Generator().manual_seed(sum(counts) + len(counts))
    E, K, N = len(counts), 64, 48
    x = torch.randn(sum(counts), K, generator=g).to(torch.bfloat16)
    w = (torch.randn(E, K, N, generator=g) * 0.1).to(torch.bfloat16)
    offsets = torch.tensor([0] + torch.tensor(counts).cumsum(0).tolist())
    got = moe.library_grouped_mm(x, w, offsets)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), moe.grouped_mm_ref(x, w, offsets).float(), rtol=2 ** -7, atol=1e-3)


def test_grouped_mm_plain_version_skips_empty_experts():
    x = torch.arange(12.0).view(4, 3)
    w = torch.stack([torch.eye(3) * (e + 1) for e in range(3)])
    y = moe.grouped_mm(x, w, torch.tensor([0, 0, 3, 4]))
    torch.testing.assert_close(y, torch.cat([x[:3] * 2, x[3:] * 3]))


def test_build_model_without_init_allocates_only():
    """``init=False`` registers the same tree, allocated and not drawn;
    the default still draws from the generator."""
    cfg = get_arch("qwen2-0.5b").reduced()
    empty = build_model(cfg, "cpu", init=False)
    drawn = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    again = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    assert [(n, p.shape, p.dtype) for n, p in empty.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in drawn.named_parameters()]
    assert all(torch.equal(a, b) for a, b in zip(drawn.parameters(), again.parameters()))


def test_default_softmax_scale_leaves_qwen2_logits_bitwise(monkeypatch):
    """qwen2-0.5b reduced: prefill and 4 decode steps with the config's
    scale passed (1/sqrt(hd)) equal, bit for bit, the same steps with the
    attention functions left to their own default."""
    cfg = get_arch("qwen2-0.5b").reduced()
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(2))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(3))

    def run():
        logits, cache = model.prefill({"tokens": tokens})
        out = [logits]
        cache = model.grow_cache(cache, 64, 68)
        for j in range(4):
            logits, cache = model.decode_step(logits.argmax(-1), cache, 64 + j)
            out.append(logits)
        return out

    with_scale = run()
    for name in ("chunked_attention", "decode_attention"):
        fn = getattr(blocks, name)
        monkeypatch.setattr(blocks, name, lambda *a, _fn=fn, scale=None, **kw: _fn(*a, **kw))
    default = run()
    assert all(torch.equal(a, b) for a, b in zip(with_scale, default))
