"""The port's LM serving path on a mesh, in a world of 4 gloo processes:
dense (qwen2-0.5b), sliding window (h2o-danube-1.8b) and MoE under both
expert rules (olmoe-1b-7b expert-parallel; mixtral-8x22b with 6 experts on
model = 4, so TP inside each expert) on (data 1, model 4) and (2, 2),
reduced. Sharded prefill logits, the first decode step's logits and
``ServeEngine`` greedy tokens against the same weights unsharded (the
unsharded port is held against the reference elsewhere); the collectives of
one decode step (no parameter all-gathered); ``compressed_psum_int8`` over 4
ranks against the reference under ``jax.vmap(..., axis_name="d")``. One
spawn for the file (``tests/torch_sharded.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_sharded import run_world

TOL = 1e-4
MESHES = [(1, 4), (2, 2)]
FAMILIES = {"dense": ("qwen2-0.5b", {}), "sliding window": ("h2o-danube-1.8b", {}),
            "moe expert-parallel": ("olmoe-1b-7b", {}),
            "moe tp in experts": ("mixtral-8x22b", {"n_experts": 6})}
CASES = {f"{fam} {m[0]}x{m[1]}": {"arch": arch, "mesh": m, "overrides": ov}
         for fam, (arch, ov) in FAMILIES.items() for m in MESHES}
# mixtral's own 8 experts on model = 2: expert-parallel there
CASES["mixtral 8 experts 2x2"] = {"arch": "mixtral-8x22b", "mesh": (2, 2)}

_rng = np.random.default_rng(11)
GRADS = (_rng.standard_normal((4, 64, 33)) * np.array([1.0, 0.1, 3.0, 0.5])[:, None, None]).astype(np.float32)
RESIDUALS = (_rng.standard_normal((4, 64, 33)) * 0.01).astype(np.float32)
CASES["psum"] = {"grads": GRADS, "residuals": RESIDUALS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(CASES, 4, tmp_path_factory.mktemp("world"))


def _case(world, name):
    out = world[0][name]
    assert "error" not in out, out.get("error")
    return out


@pytest.mark.parametrize("name", [n for n in CASES if n != "psum"])
def test_sharded_prefill_and_decode_logits_equal_unsharded(world, name):
    out = _case(world, name)
    assert out["prefill_err"] <= TOL and out["decode_err"] <= TOL, out


@pytest.mark.parametrize("name", [n for n in CASES if n != "psum"])
def test_sharded_greedy_tokens_equal_unsharded(world, name):
    out = _case(world, name)
    assert out["tokens"] == out["ref_tokens"] and len(out["tokens"]) == 4
    for r in range(1, 4):  # every rank served the same tokens
        assert world[r][name]["tokens"] == out["tokens"]


@pytest.mark.parametrize("name", [n for n in CASES if n != "psum"])
def test_decode_step_gathers_no_parameter(world, name):
    out = _case(world, name)
    assert out["gathered_params"] == []
    assert out["log_counts"] == {k.split(".")[-1]: v for k, v in out["comm_counts"].items()}
    assert sum(out["comm_counts"].values()) > 0  # the step did talk over the mesh


def test_weights_are_laid_out_by_the_rules(world):
    out = _case(world, "dense 1x4")
    assert out["placements"]["layers.attn.wq"] == "(Replicate(), Shard(dim=2))"
    assert out["placements"]["layers.mlp.down"] == "(Replicate(), Shard(dim=1))"
    assert out["placements"]["embed.tok"] == "(Replicate(), Shard(dim=0))"
    assert out["placements"]["ln_f"] == "(Replicate(), Replicate())"
    # 2 kv heads on model = 4: the cache shards the head dim
    assert out["cache_placements"]["k"] == "(Shard(dim=1), Shard(dim=4))"
    moe = _case(world, "moe expert-parallel 1x4")["placements"]
    assert moe["layers.moe.gate"] == "(Replicate(), Shard(dim=1))"
    tp = _case(world, "moe tp in experts 1x4")["placements"]
    assert tp["layers.moe.gate"] == "(Replicate(), Shard(dim=3))"


@pytest.mark.parametrize("rank", range(4))
def test_compressed_psum_int8_over_four_ranks_equals_reference(world, rank):
    from repro.distributed.compression import CompressionState as RefState
    from repro.distributed.compression import compressed_psum_int8 as ref_psum

    mean, res = jax.vmap(lambda g, r: ref_psum(g, RefState(r), "d"), axis_name="d")(
        jnp.asarray(GRADS), jnp.asarray(RESIDUALS))
    got = world[rank]["psum"]
    assert "error" not in got, got.get("error")
    np.testing.assert_allclose(got["mean"], np.asarray(mean[rank]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["residual"], np.asarray(res.residual[rank]), atol=1e-6, rtol=0)
