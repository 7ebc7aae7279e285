"""The port's multi-pod dry-run (``repro_torch.launch.dryrun``) and its op
stream analyzer (``repro_torch.launch.hlo_analysis``) against the reference's
``repro.launch.{dryrun,hlo_analysis}``.

Each fake world runs in a child process (``tests/torch_dryrun_child.py``, one
world a process), all started together; the real steps (d) run in a world of
4 gloo processes (``tests/torch_sharded_train.py``).

(a) The reference's SYNTHETIC_HLO, 24 x (a 16x128 @ 128x128 dot + an
    all-reduce over a 16-rank group), run as ops on a fake world of 256
    (16x16, the all-reduce over ``model``) and of 512 (2x16x16, over
    ``pod``): FLOPs, collective bytes by kind and their cross-pod part equal
    ``analyze_hlo``'s on the HLO (its cross-pod variant for ``pod``).
(b) FLOPs of reduced steps on a world of 1 (train B 2 x S 128, prefill,
    decode at a cache of 128) against the reference's ``analyze_hlo`` of the
    same jitted step: the ratio pinned within 10 % (``PERF.md`` section 6
    says why each is not 1), and the train step's within (0.5, 3.0)
    of 6 N D, the reference's own bound.
(c) The 18 skipped cells' records equal the reference's ``lower_cell``
    records, and ``--all`` plans the reference's 80 (arch, shape, mesh)
    triples in its order.
(d) A reduced qwen2 decode step and train step on (data 1, model 4): the
    dry-run's traced collectives equal ``CollectiveLog``'s of the real step
    on gloo, in kind, count and bytes; on a world of 1, the traced peak of a
    train step equals ``OpTrace``'s peak over the same step on real tensors.
(h) ``act_sharding.local_block`` (integer arithmetic on the mesh coordinate,
    safe under fake and meta tensors) against torch's own
    ``_compute_local_shape_and_global_offset``, for every layout the rules
    give every arch on the 16x16, 2x16x16, 1x4 and 2x2 meshes.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.config import SHAPES, cell_runnable, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as sh
from repro_torch.launch.act_sharding import local_block
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import build_model
from repro_torch.models.spec import tree_items
from test_dryrun import SYNTHETIC_HLO
from torch_sharded_train import run_world

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "torch_dryrun_child.py"
FAMILIES = ("dense", "moe", "ssm")
KINDS = ("train", "prefill", "decode")
# port FLOPs / the reference's analyze_hlo FLOPs of the same step (PERF.md
# section 6): equal but where the port's eager program recomputes what XLA's
# does not (each checkpointed CE chunk's head product in backward), and the
# SSM train step's depthwise-conv backward, which each analyzer counts by
# its own formula (neither reads the group count)
PINNED = {("dense", "train"): 1.023, ("moe", "train"): 1.012, ("ssm", "train"): 0.754,
          ("dense", "prefill"): 1.0, ("moe", "prefill"): 1.0, ("ssm", "prefill"): 1.013,
          ("dense", "decode"): 1.0, ("moe", "decode"): 1.0, ("ssm", "decode"): 1.0}
WORLDS = {
    256: ["synthetic:model"],
    512: ["synthetic:pod"],
    1: [f"flops:{f}:{k}" for f in FAMILIES for k in KINDS] + ["peak_pair"],
    4: ["comms:decode", "comms:train"],
}


@pytest.fixture(scope="module")
def traced():
    """Every fake-world job, one child process a world, run together."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {w: subprocess.Popen([sys.executable, str(CHILD), str(w), *jobs], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
             for w, jobs in WORLDS.items()}
    out = {}
    for w, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        for line in stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                out[rec["job"]] = rec["result"]
    return out


# ------------------------------------------------------ (a) synthetic program
@pytest.mark.parametrize("axis", ["model", "pod"])
def test_synthetic_program_equals_analyze_hlo(traced, axis):
    got = traced[f"synthetic:{axis}"]
    hlo = SYNTHETIC_HLO
    if axis == "pod":
        hlo = hlo.replace("replica_groups=[16,16]<=[256]", "replica_groups=[256,2]<=[2,256]T(1,0)")
    want = analyze_hlo(hlo)
    for key in ("flops", "coll", "coll_total", "coll_cross", "coll_intra"):
        assert got[key] == want[key], key
    assert got["flops"] == 24 * 2 * 16 * 128 * 128 and got["coll_total"] == 24 * 16 * 128 * 4
    assert got["coll_cross"] == (got["coll_total"] if axis == "pod" else 0)
    # one row: the all-reduce, its count where the reference has its trip count
    assert got["top"] == [[24 * 16 * 128 * 4, "all-reduce", "f32[16,128]", 16 * 128 * 4, 24]]


# ------------------------------------------------- (b) FLOPs, 6ND, reference
@pytest.fixture(scope="module")
def ref_flops():
    """The reference's ``analyze_hlo`` FLOPs of each reduced step, from
    abstract inputs (nothing allocated)."""
    import jax

    from repro.config.model import ShapeConfig
    from repro.config.registry import get_arch as ref_get_arch
    from repro.models import build_model as ref_build_model
    from repro.models.spec import tree_abstract
    from repro.training import cosine_schedule, make_train_step, train_state_init

    out = {}
    for family in FAMILIES:
        model = ref_build_model(ref_get_arch(dict(dense="qwen2-0.5b", moe="olmoe-1b-7b",
                                                  ssm="falcon-mamba-7b")[family]).reduced())
        params = tree_abstract(model.param_specs())
        for kind in KINDS:
            specs = model.input_specs(ShapeConfig(kind, 128, 2, kind))
            if kind == "train":
                state = jax.eval_shape(lambda k: train_state_init(model, k), jax.random.PRNGKey(0))
                low = jax.jit(make_train_step(model, cosine_schedule(3e-4, 100, 10000))).lower(state, specs)
            elif kind == "prefill":
                low = jax.jit(model.prefill).lower(params, specs)
            else:
                low = jax.jit(model.decode_step).lower(params, specs["tokens"], specs["cache"], specs["pos"])
            out[(family, kind)] = analyze_hlo(low.compile().as_text())["flops"]
    return out


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", KINDS)
def test_flops_ratio_to_reference_is_pinned(traced, ref_flops, family, kind):
    ratio = traced[f"flops:{family}:{kind}"] / ref_flops[(family, kind)]
    assert abs(ratio / PINNED[(family, kind)] - 1) <= 0.10, ratio


def test_train_flops_track_model_flops(traced):
    cfg = get_arch("qwen2-0.5b").reduced()
    n = sum(s.numel() for _, s in tree_items(build_model(cfg, "meta").abstract_params()))
    assert 0.5 < traced["flops:dense:train"] / (6 * n * 2 * 128) < 3.0


# ------------------------------------------------------- (c) skipped cells
SKIPPED = [c for c in dryrun.all_cells() if not cell_runnable(get_arch(c[0]), SHAPES[c[1]])[0]]


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module; it sets XLA_FLAGS at import (512 host
    devices), which is put back at once."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def test_eighteen_cells_are_skipped():
    assert len(SKIPPED) == 18


@pytest.mark.parametrize("cell", SKIPPED, ids=lambda c: "-".join(c))
def test_skipped_cell_records_equal_reference(ref_dryrun, cell):
    arch, shape, mesh = cell
    got = dryrun.lower_cell(arch, shape, mesh == "multi", device="cpu")
    assert got == ref_dryrun.lower_cell(arch, shape, mesh == "multi")
    assert got["status"] == "skipped"


def test_all_plans_the_reference_cells():
    from repro.config.model import SHAPES as REF_SHAPES
    from repro.config.registry import list_archs as ref_list_archs

    want = [(a, s, m) for a in ref_list_archs() for s in REF_SHAPES for m in ("single", "multi")]
    assert dryrun.all_cells() == want and len(want) == 80


# --------------------------------------------- (d) traces against real runs
_NAMES = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


@pytest.fixture(scope="module")
def real_comms(tmp_path_factory):
    cases = {k: {"kind": "comms", "step": k} for k in ("decode", "train")}
    return run_world(cases, 4, tmp_path_factory.mktemp("world"))[0]


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_traced_collectives_equal_the_real_step(traced, real_comms, kind):
    real = real_comms[kind]
    assert "error" not in real, real.get("error")
    counts, nbytes = {}, {}
    for name, _, b in real["calls"]:
        counts[_NAMES[name]] = counts.get(_NAMES[name], 0) + 1
        nbytes[_NAMES[name]] = nbytes.get(_NAMES[name], 0) + b
    got = traced[f"comms:{kind}"]
    assert got["counts"] == counts
    assert got["bytes"] == pytest.approx(nbytes, abs=0)
    assert sum(counts.values()) > 0


def test_traced_peak_equals_the_real_step(traced):
    pair = traced["peak_pair"]
    assert pair["traced"] == pair["real"] > 0
    assert pair["traced_flops"] == pair["real_flops"] > 0


# ------------------------------------------ (h) fake-safe shard arithmetic
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x4": ((1, 4), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}


class _At:
    """A mesh seen from one coordinate (all ``local_block`` reads)."""

    def __init__(self, sizes, coord):
        self.sizes, self.coord = sizes, coord

    def get_coordinate(self):
        return list(self.coord)

    def size(self, i):
        return self.sizes[i]


def _layouts(arch, mesh):
    model = build_model(get_arch(arch), "meta")
    specs = dict(tree_items(model.param_specs()))
    for fsdp in (False, True):
        for path, s in tree_items(sh.param_shardings(model, mesh, fsdp=fsdp)):
            yield specs[path].shape, s.spec
    for shape in SHAPES.values():
        if cell_runnable(model.cfg, shape)[0] and model.cfg.has_decode:
            cache = dict(tree_items(model.cache_specs(shape.global_batch, shape.seq_len)))
            for path, s in tree_items(sh.cache_shardings(model, mesh, shape)):
                yield cache[path].shape, s.spec


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", dryrun.list_archs())
def test_local_block_equals_torch(arch, mesh):
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    sizes, axes = MESHES[mesh]
    coords = {tuple(0 for _ in sizes), tuple(s - 1 for s in sizes), tuple(s // 2 for s in sizes)}
    n = 0
    for shape, spec in _layouts(arch, mesh=AbstractMesh(sizes, axes)):
        placements = sh.to_placements(spec, AbstractMesh(sizes, axes))
        for coord in coords:
            got = local_block(shape, _At(sizes, coord), placements)
            want = _compute_local_shape_and_global_offset(shape, sizes, list(coord), placements)
            assert got == (tuple(want[0]), tuple(want[1])), (shape, spec, coord)
            n += 1
    assert n > 0


# ------------------------------------------------------------- no side effects
_IMPORT = """
import os, sys
before = dict(os.environ)
import repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis
import torch.distributed as dist
print(dict(os.environ) == before, dist.is_initialized(), "jax" in sys.modules)
"""


def test_import_starts_no_world_and_sets_no_environment():
    out = subprocess.run([sys.executable, "-c", _IMPORT], capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.stdout.split() == ["True", "False", "False"]


def test_cuda_is_the_default_device_and_raises_without_it():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b",
                          "--shape", "decode_32k"], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 1 and "CUDA is not available" in out.stdout
