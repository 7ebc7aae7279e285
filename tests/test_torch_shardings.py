"""The port's multi-card launch layer against the reference's, with no world
of cards: ``repro_torch.launch.shardings`` on the port's ``AbstractMesh``
against ``repro.launch.shardings`` on ``jax.sharding.AbstractMesh``, pspec
for pspec (the port's pspec is a tuple written as JAX's ``P``), for every
arch x SHAPES x mesh; the abstract inputs and parameters; the reference's
``TestShardingRules``; ``constrain``; ``make_production_mesh`` on a fake
world (``torch.testing._internal.distributed.fake_pg``)."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as P

from repro.config.model import SHAPES as REF_SHAPES
from repro.config.model import cell_runnable as ref_cell_runnable
from repro.config.registry import get_arch as ref_get_arch
from repro.config.registry import list_archs
from repro.launch import shardings as ref_sh
from repro.models.model import build_model as ref_build_model
from repro.models.spec import tree_abstract as ref_tree_abstract
from repro.training.optimizer import AdamWState as RefAdamWState
from repro.training.train_step import TrainState as RefTrainState
from repro_torch.config import SHAPES, cell_runnable, get_arch
from repro_torch.distributed.compression import CompressionState
from repro_torch.launch import hw
from repro_torch.launch import shardings as sh
from repro_torch.launch.act_sharding import activation_sharding, constrain, merge_dims, split_dim
from repro_torch.launch.mesh import AbstractMesh, mesh_info
from repro_torch.models import build_model
from repro_torch.models.spec import TensorSpec, tree_abstract, tree_items
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_step import TrainState

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x4": ((1, 4), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}
ARCHS = list_archs()


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), JaxAbstractMesh(sizes, axes)


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        _MODELS[arch] = (build_model(get_arch(arch), "meta"), ref_build_model(ref_get_arch(arch)))
    return _MODELS[arch]


def _specs(tree):
    """A sharding tree as nested dicts of pspec tuples (either package)."""
    if tree is None:
        return None
    if isinstance(tree, (sh.NamedSharding, JaxNamedSharding)):
        return tuple(tree.spec)
    if hasattr(tree, "_fields"):
        return {f: _specs(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    raise TypeError(type(tree))


def _ref_state(model, comp: bool):
    params = ref_tree_abstract(model.param_specs())
    f32 = lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32)
    opt = RefAdamWState(step=jax.ShapeDtypeStruct((), jnp.int32), m=jax.tree.map(f32, params),
                        v=jax.tree.map(f32, params), master=jax.tree.map(f32, params))
    return RefTrainState(params=params, opt=opt, comp=params if comp else None)


def _port_state(model, comp: bool):
    params = model.abstract_params()
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    tm = lambda fn, t: {k: tm(fn, v) if isinstance(v, dict) else fn(v) for k, v in t.items()}
    opt = AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"), m=tm(f32, params),
                     v=tm(f32, params), master=tm(f32, params))
    return TrainState(params=params, opt=opt, comp=tm(CompressionState, params) if comp else None)


# ------------------------------------------------ pspecs, entry for entry
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fn", ["params", "params_fsdp", "opt_state", "opt_state_comp"])
def test_param_and_state_pspecs_equal_reference(arch, mesh, fn):
    port, ref = _models(arch)
    pm, jm = _meshes(mesh)
    if fn.startswith("params"):
        fsdp = fn == "params_fsdp"
        got = sh.param_shardings(port, pm, fsdp=fsdp)
        want = ref_sh.param_shardings(ref, jm, fsdp=fsdp)
    else:
        comp = fn == "opt_state_comp"
        got = sh.opt_state_shardings(port, pm, _port_state(port, comp))
        want = ref_sh.opt_state_shardings(ref, jm, _ref_state(ref, comp))
    assert _specs(got) == _specs(want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fn", ["activation", "input", "cache"])
def test_activation_input_cache_pspecs_equal_reference(arch, shape, mesh, fn):
    port, ref = _models(arch)
    pm, jm = _meshes(mesh)
    if fn == "activation":
        got = sh.activation_rules(pm, SHAPES[shape], port.cfg)
        want = ref_sh.activation_rules(jm, REF_SHAPES[shape], ref.cfg)
        assert sh.activation_rules(pm, SHAPES[shape]).keys() == ref_sh.activation_rules(jm, REF_SHAPES[shape]).keys()
    else:
        def ref_fn():
            if fn == "input":
                return ref_sh.input_shardings(ref, jm, REF_SHAPES[shape], ref.input_specs(REF_SHAPES[shape]))
            return ref_sh.cache_shardings(ref, jm, REF_SHAPES[shape])

        def port_fn():
            if fn == "input":
                return sh.input_shardings(port, pm, SHAPES[shape], port.input_specs(SHAPES[shape]))
            return sh.cache_shardings(port, pm, SHAPES[shape])

        try:
            want = ref_fn()
        except ValueError:  # an encoder has no decode cache, in both packages
            assert port.cfg.family == "encoder"
            with pytest.raises(ValueError):
                port_fn()
            return
        got = port_fn()
    assert _specs(got) == _specs(want)


# ------------------------------------------------------- abstract inputs
def _shapes_dtypes(tree, jax_side: bool):
    out = {}
    for path, leaf in tree_items(tree):
        name = str(leaf.dtype) if jax_side else str(leaf.dtype).removeprefix("torch.")
        out[path] = (tuple(leaf.shape), name)
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_abstract_params_equal_reference(arch, shape):
    port, ref = _models(arch)
    ok, reason = cell_runnable(port.cfg, SHAPES[shape])
    assert (ok, reason) == ref_cell_runnable(ref.cfg, REF_SHAPES[shape])
    got = _shapes_dtypes(port.abstract_params(), False)
    assert got == _shapes_dtypes(ref.abstract_params(), True)
    assert got == _shapes_dtypes(tree_abstract(port.param_specs()), False)
    assert all(t.device.type == "meta" for _, t in tree_items(port.abstract_params()))
    if not ok:
        return
    ins = port.input_specs(SHAPES[shape])
    assert list(ins) == list(ref.input_specs(REF_SHAPES[shape]))
    assert _shapes_dtypes(ins, False) == _shapes_dtypes(ref.input_specs(REF_SHAPES[shape]), True)
    assert all(t.device.type == "meta" for _, t in tree_items(ins))


def test_tensor_spec_abstract_is_a_meta_tensor():
    t = TensorSpec((3, 5), ("embed", None), torch.float32).abstract()
    assert t.device.type == "meta" and t.shape == (3, 5) and t.dtype == torch.float32


def test_the_110b_model_is_named_but_never_allocated():
    model = build_model(get_arch("qwen1.5-110b"), "meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == 111_209_914_368 == model.cfg.param_count()
    assert all(p.device.type == "meta" for p in model.parameters())


# ---------------------------------------- the reference's TestShardingRules
class FakeMesh:
    shape = {"model": 16, "data": 16}
    axis_names = ("data", "model")


def test_smoke_mesh_has_production_axes():
    info = mesh_info(AbstractMesh((1, 1), ("data", "model")))
    assert set(info["axes"]) == {"data", "model"} and not info["multi_pod"] and info["n_devices"] == 1


def test_moe_rules_divisibility():
    r_olmoe = sh.logical_rules(get_arch("olmoe-1b-7b"), FakeMesh())
    r_mixtral = sh.logical_rules(get_arch("mixtral-8x22b"), FakeMesh())
    assert r_olmoe["experts"] == "model" and r_olmoe["mlp"] is None
    assert r_mixtral["experts"] is None and r_mixtral["mlp"] == "model"


def test_fsdp_pspec_shards_large_tensors_only():
    rules = {"embed": None, "heads": "model"}
    big = TensorSpec((4096, 4096), ("embed", "heads"))
    small = TensorSpec((4096,), ("embed",))
    assert sh.fsdp_pspec(big, rules, FakeMesh()) == tuple(P("data", "model")) == ("data", "model")
    assert sh.fsdp_pspec(small, rules, FakeMesh()) == tuple(P(None)) == (None,)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_never_reuse_axis(arch):
    cfg = get_arch(arch)
    rules = sh.logical_rules(cfg, FakeMesh())
    mesh = AbstractMesh((16, 16), ("data", "model"))
    for _, s in tree_items(build_model(cfg, "meta").param_specs()):
        spec = sh.fsdp_pspec(s, rules, FakeMesh())
        flat = [a for e in spec for a in sh.entry_axes(e)]
        assert len(flat) == len(set(flat)), (arch, s, spec)
        sh.to_placements(spec, mesh)  # raises on a reused axis


# ---------------------------------------------------------- placements
def test_pspec_normalises_as_partition_spec():
    for entries in [(("data",), "model", None), (("pod", "data"), None), ((), "model"), ()]:
        assert sh.pspec(*entries) == tuple(P(*entries))


def test_to_placements_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.to_placements(sh.pspec(("pod", "data"), "model", None), mesh) == (Shard(0), Shard(0), Shard(1))
    assert sh.to_placements(sh.pspec(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        sh.to_placements(sh.pspec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        sh.to_placements(sh.pspec("model", "model"), mesh)


def test_h100_figures():
    assert (hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.HBM_PER_CHIP) == (989e12, 3.35e12, 80e9)
    assert hw.ICI_BW > hw.DCI_BW > 0 and hw.PEAK_FLOPS_F32 == 67e12


# -------------------------------------------------------------- constrain
@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    import torch.distributed as dist

    init = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0, world_size=1)
    from repro_torch.launch.mesh import make_smoke_mesh

    yield make_smoke_mesh("cpu")
    dist.destroy_process_group()


def test_make_smoke_mesh_is_one_by_one(world_of_one):
    assert mesh_info(world_of_one) == {"axes": {"data": 1, "model": 1}, "n_devices": 1, "multi_pod": False}


def test_constrain_is_a_no_op_outside_a_mesh_and_on_plain_tensors(world_of_one):
    from torch.distributed.tensor import Replicate, distribute_tensor

    x = torch.randn(2, 3, 4)
    d = distribute_tensor(x, world_of_one, (Replicate(), Replicate()))
    assert constrain(x, "residual") is x and constrain(d, "residual") is d
    rules = sh.activation_rules(world_of_one, SHAPES["prefill_32k"])
    with activation_sharding(rules):
        assert constrain(x, "residual") is x
        assert constrain(d, "no such rule") is d


def test_constrain_redistributes_and_skips_a_rank_mismatch(world_of_one):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    rules = sh.activation_rules(world_of_one, SHAPES["prefill_32k"])
    d3 = distribute_tensor(torch.randn(2, 3, 4), world_of_one, (Replicate(), Replicate()))
    d2 = distribute_tensor(torch.randn(2, 4), world_of_one, (Replicate(), Replicate()))
    with activation_sharding(rules):
        out = constrain(d3, "residual")
        assert tuple(out.placements) == (Shard(0), Shard(1))
        assert torch.equal(out.full_tensor(), d3.full_tensor())
        assert constrain(d2, "residual") is d2  # rank 2 under a rank-3 rule
    assert constrain(d3, "residual") is d3  # the context is gone


def test_split_and_merge_dims_on_plain_tensors_are_reshapes():
    x = torch.arange(24.0).reshape(2, 12)
    assert torch.equal(split_dim(x, -1, (3, 4)), x.reshape(2, 3, 4))
    assert torch.equal(merge_dims(x.reshape(2, 3, 4), 1), x)


# ------------------------------------------- production meshes, fake world
_FAKE = """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=3, world_size={world})
from repro_torch.config import get_arch
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh, mesh_info
from repro_torch.launch import shardings as sh
from repro_torch.models import build_model
from repro_torch.models.spec import tree_items
mesh = make_production_mesh(multi_pod={multi}, device_type="cpu")
info = mesh_info(mesh)
model = build_model(get_arch("qwen1.5-110b"), "meta")
abstract = AbstractMesh(tuple(info["axes"].values()), tuple(info["axes"]))
real = sh.param_shardings(model, mesh)
same = all(a.spec == b.spec and a.placements() == b.placements()
           for (_, a), (_, b) in zip(tree_items(real), tree_items(sh.param_shardings(model, abstract))))
print(info, same)
"""


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_world(multi_pod):
    world = 512 if multi_pod else 256
    out = subprocess.run([sys.executable, "-c", _FAKE.format(world=world, multi=multi_pod)],
                         capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    info, same = out.stdout.strip().rsplit(" ", 1)
    axes = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    assert info == str({"axes": axes, "n_devices": world, "multi_pod": multi_pod}) and same == "True"
