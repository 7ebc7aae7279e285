"""The port's training step on a mesh, and its decode over a cache sharded
along the sequence, in one world of 4 gloo processes
(``tests/torch_sharded_train.py``).

Train: every family reduced (dense qwen2-0.5b with its tied head, sliding
window h2o-danube-1.8b, MoE expert-parallel olmoe-1b-7b and TP inside the
experts mixtral-8x22b with 6 experts on model = 4, SSM falcon-mamba-7b,
hybrid zamba2-2.7b) placed with FSDP on (1, 4) and (2, 2), its AdamW state
laid out by ``opt_state_shardings``, remat "full" (the configs' default);
two steps against the unsharded port from the same f32 weights, kept in f32
(AdamW's ``param_dtype``, in the worker processes): loss and
gnorm within 1e-4 relative, every master leaf within 1e-4 (atol and rtol)
but where AdamW's sign-like first steps met a gradient within rounding of
zero (``torch_train.assert_master_close``: at most 0.01 % of a leaf, each
within 2 x the learning rates summed). Also microbatches 2 against 1, remat
"none", and int8 gradient compression.

Decode: zamba2-2.7b reduced, B 1, its K/V cache sharded along the sequence
(``long_500k``'s ``cache_seq``) on (4, 1) and (2, 2), 16 slots, 12 greedy
steps from an empty cache, so that ``pos`` crosses shard boundaries: logits
within 1e-4 of the unsharded model, greedy tokens equal."""
import numpy as np
import pytest

from torch_sharded_train import run_world
from torch_train import assert_master_close

TOL = 1e-4
MESHES = [(1, 4), (2, 2)]
FAMILIES = {"dense": ("qwen2-0.5b", {}), "sliding window": ("h2o-danube-1.8b", {}),
            "moe expert-parallel": ("olmoe-1b-7b", {}),
            "moe tp in experts": ("mixtral-8x22b", {"n_experts": 6}),
            "ssm": ("falcon-mamba-7b", {}), "hybrid": ("zamba2-2.7b", {})}
CASES = {f"{fam} {m[0]}x{m[1]}": {"kind": "train", "arch": arch, "mesh": m, "overrides": ov}
         for fam, (arch, ov) in FAMILIES.items() for m in MESHES}
CASES["dense microbatches 2 against 1, 2x2"] = {"kind": "train", "arch": "qwen2-0.5b", "mesh": (2, 2),
                                              "microbatches": 2, "ref_microbatches": 1}
CASES["dense remat none 2x2"] = {"kind": "train", "arch": "qwen2-0.5b", "mesh": (2, 2),
                                 "overrides": {"remat": "none"}}
CASES["dense int8 compression 2x2"] = {"kind": "train", "arch": "qwen2-0.5b", "mesh": (2, 2),
                                       "compression": True}
TRAIN = list(CASES)
DECODE = {f"hybrid long_500k decode {m[0]}x{m[1]}": {"kind": "decode", "arch": "zamba2-2.7b", "mesh": m,
                                                      "cache": 16, "steps": 12} for m in [(4, 1), (2, 2)]}
CASES.update(DECODE)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(CASES, 4, tmp_path_factory.mktemp("world"))


def _case(world, name):
    out = world[0][name]
    assert "error" not in out, out.get("error")
    return out


@pytest.mark.parametrize("name", TRAIN)
def test_sharded_train_steps_equal_unsharded(world, name):
    out = _case(world, name)
    for i, (got, want) in enumerate(zip(out["metrics"], out["ref_metrics"])):
        for key in ("loss", "gnorm", "lr", "step"):
            np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=f"{name} step {i} {key}")


@pytest.mark.parametrize("name", TRAIN)
def test_sharded_master_weights_equal_unsharded(world, name):
    out = _case(world, name)
    assert set(out["master"]) == set(out["ref_master"])
    for path, got in out["master"].items():
        assert_master_close(got, out["ref_master"][path], out["lr_sum"], f"{name} {path}")


@pytest.mark.parametrize("name", TRAIN)
def test_state_laid_out_by_opt_state_shardings(world, name):
    out = _case(world, name)
    assert out["laid_out"]
    # FSDP (the size floor lowered for the reduced leaves) shards over data
    # on (2, 2); the metrics come out as plain tensors on every rank
    if "2x2" in name:
        assert out["fsdp_leaves"]
    assert out["metric_types"] == ["Tensor"]
    assert out["master_placements"] == out["param_placements"]


def test_ranks_agree_on_the_metrics(world):
    for name in TRAIN:
        ranks = [world[r][name]["metrics"] for r in range(4)]
        assert all(r == ranks[0] for r in ranks), name


@pytest.mark.parametrize("name", list(DECODE))
def test_sequence_sharded_decode_equals_unsharded(world, name):
    out = _case(world, name)
    assert "Shard(dim=2)" in out["cache_placements"]["k"].split(",")[0]  # the sequence over data
    assert max(out["errs"]) <= TOL, out["errs"]
    assert out["tokens"] == out["ref_tokens"]
    assert out["k_err"] <= TOL
