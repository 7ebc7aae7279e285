"""The port's other LM families on a mesh, in a world of 4 gloo processes:
SSM (falcon-mamba-7b), hybrid (zamba2-2.7b), VLM (llava-next-34b, prefill)
and encoder (hubert-xlarge, prefill), reduced, on (data 1, model 4) and
(2, 2); and the dense model with qwen2-0.5b's own 14 query / 2 KV heads,
which split unevenly over model = 4. Logits within 1e-4 of the same weights
unsharded, greedy tokens equal, no parameter all-gathered in a decode step.
The SSM blocks run on local shards with their collectives written out
(``launch.act_sharding.ModelAxis``). One spawn for the file."""
import pytest

from torch_sharded import run_world

TOL = 1e-4
MESHES = [(1, 4), (2, 2)]
FAMILIES = {"ssm": ("falcon-mamba-7b", {}), "hybrid": ("zamba2-2.7b", {}),
            "vlm": ("llava-next-34b", {}), "encoder": ("hubert-xlarge", {}),
            "dense 14/2 heads": ("qwen2-0.5b", {"n_heads": 14})}
CASES = {f"{fam} {m[0]}x{m[1]}": {"arch": arch, "mesh": m, "overrides": ov}
         for fam, (arch, ov) in FAMILIES.items() for m in MESHES}
# weights drawn shard by shard on each rank (place_model's seed), the
# unsharded twin gathered from them (gather_model), as the card's 110B run
CASES["dense seeded 2x2"] = {"arch": "qwen2-0.5b", "mesh": (2, 2), "seed": 5}
CASES["ssm seeded 1x4"] = {"arch": "falcon-mamba-7b", "mesh": (1, 4), "seed": 5}
SERVED = [n for n in CASES if not n.startswith(("vlm", "encoder"))]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(CASES, 4, tmp_path_factory.mktemp("world"))


def _case(world, name):
    out = world[0][name]
    assert "error" not in out, out.get("error")
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_prefill_logits_equal_unsharded(world, name):
    out = _case(world, name)
    assert out["prefill_err"] <= TOL, out
    want = (4, 16, 512) if name.startswith("encoder") else (4, 512)
    assert out["prefill_shape"] == want


@pytest.mark.parametrize("name", SERVED)
def test_sharded_serving_equals_unsharded(world, name):
    out = _case(world, name)
    assert out["decode_err"] <= TOL, out
    assert out["tokens"] == out["ref_tokens"]


@pytest.mark.parametrize("name", SERVED)
def test_decode_step_gathers_no_parameter(world, name):
    out = _case(world, name)
    assert out["gathered_params"] == [] and sum(out["comm_counts"].values()) > 0


def test_ssm_state_and_conv_caches_shard_their_channels(world):
    assert _case(world, "ssm 1x4")["cache_placements"] == {
        "ssm": "(Shard(dim=1), Shard(dim=2))", "conv": "(Shard(dim=1), Shard(dim=3))"}
    assert _case(world, "hybrid 2x2")["cache_placements"] == {
        "ssm": "(Shard(dim=2), Shard(dim=3))", "conv": "(Shard(dim=2), Shard(dim=4))",
        "k": "(Shard(dim=1), Shard(dim=3))", "v": "(Shard(dim=1), Shard(dim=3))"}


def test_seeded_shards_draw_the_spec_inits(world):
    """Drawn shard by shard, the leaves still hold their spec's init: ones,
    zeros, A_log = log(1..N) along its last dim at its global indices, and
    normal draws of the spec's scale that differ between shards."""
    import numpy as np

    params = _case(world, "ssm seeded 1x4")["params"]
    a_log = params["layers.mamba.A_log"]
    np.testing.assert_allclose(a_log, np.broadcast_to(np.log(np.arange(1, a_log.shape[-1] + 1)), a_log.shape),
                               rtol=1e-6)
    assert (params["ln_f"] == 1).all() and (params["layers.mamba.conv_b"] == 0).all()
    dt_b = params["layers.mamba.dt_b"]
    dt = np.log1p(np.exp(dt_b))  # softplus: the drawn dt spans [1e-3, 1e-1]
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001
    conv = params["layers.mamba.conv_w"]  # (L, K, d_inner) sharded over d_inner
    quarter = conv.shape[-1] // 4
    assert not np.array_equal(conv[..., :quarter], conv[..., quarter:2 * quarter])
    assert abs(conv.std() - 0.02) < 0.005
