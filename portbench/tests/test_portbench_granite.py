"""The granite-4.0-h-small cell at small sizes on the CPU: the port's
``layered`` stack against the plain float32 reference
(``reference/granite_hybrid.py``), the cell end to end through the
harness, its control, and the frozen FLOP count."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import harness, inputs, yardstick_layered  # noqa: E402
from portbench.drivers import serve_layered  # noqa: E402
from portbench.reference import granite_hybrid  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

CELL = "granite-4.0-h-small.serve"
# 4 layers (mamba, attention, mamba, mamba), 8 experts with top 2, a
# shared expert; every multiplier as published
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 32,
        "shared_intermediate_size": 48, "num_local_experts": 8, "num_experts_per_tok": 2,
        "mamba_d_state": 16, "mamba_d_head": 16, "mamba_n_heads": 8, "num_hidden_layers": 4,
        "layer_types": ["mamba", "attention", "mamba", "mamba"], "vocab_size": 256}
TINY_TRAFFIC = {"max_batch": 2, "batches": 4, "prompt": {"median": 12, "sigma": 0.6, "min": 4, "max": 32},
                "output": {"median": 16, "sigma": 0.6, "min": 8, "max": 24}, "sample_requests": 2}


class _Cell:
    def __init__(self, config, seed=3):
        self.config, self.seed, self.device = config, seed, torch.device("cpu")


def _config(**over):
    config = json.loads((ROOT / "portbench/configs/granite-4.0-h-small.json").read_text())
    config.update(TINY)
    config.update(over)
    return config


def test_prefill_and_decode_match_the_reference_in_f32():
    """Prefill logits, then 8 decode steps through the cache, against the
    reference's full forward over the whole sequence at each position:
    the SSD in two chunks of 16 against the quadratic form, attention in
    two blocks of 16. Float32 activations on the same (bf16-valued)
    weights: equal to float32 rounding, summed in other orders (the
    logits are ~0.05, so 2e-6 absolute is ~4e-5 of them)."""
    config = _config(torch_dtype="float32", mamba_chunk_size=16, program={"attn_chunk": 16})
    cell = _Cell(config)
    cfg, model = serve_layered.build(cell)
    top, layer_weights = serve_layered.reference_weights(cell)
    toks = torch.as_tensor(inputs.zipf_tokens(inputs.rng(3, "t"), (2, 40), config["vocab_size"], 1.3))
    want = [granite_hybrid.logits(top, layer_weights, config, [row], [31])[0] for row in toks]
    got, cache = model.prefill({"tokens": toks[:, :32]})
    cache = ServeEngine._grow_cache(cache, 32, 40, model)
    steps = [got]
    for j in range(8):
        logits, cache = model.decode_step(toks[:, 32 + j], cache, 32 + j)
        steps.append(logits)
    for b in range(2):
        for j, logits in enumerate(steps):
            torch.testing.assert_close(logits[b], want[b][j], rtol=0, atol=2e-6)
    counts = model.moe_counters()
    assert counts["moe_pairs_dropped"] == 0 and counts["moe_pairs_routed"] == 4 * 2 * 2 * (32 + 8)


def test_cell_runs_end_to_end_and_correct():
    """The cell through the harness at a tiny size in bf16: every check
    within its limit, every pair routed, the counters read."""
    notes = {}
    out = harness.run_cell(CELL, 2**31 + 19, 0.2, False, t_start=time.perf_counter(), device="cpu",
                           require_card=False, notes=notes, check_imports=False,
                           overrides={"config": TINY, "traffic": TINY_TRAFFIC})
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"served_logit_gap", "served_logit_error", "unfinished_requests",
                                  "missing_requests", "moe_pairs_dropped"}
    assert set(out["metrics"]) == {"setup_s", "serve_tokens_per_s"}
    c = notes["counters"]
    assert c["moe_pairs_dropped"] == 0 and c["moe_pairs_routed"] > 0 and c["expert_gemm_calls"]["decode"] > 0
    assert 0 < c["experts_used"]["decode"] <= 8 * c["expert_gemm_calls"]["decode"] // 3


# the tiny stack's logits are ~30x smaller than the cut's, so its limit on
# the logit error is set as the cut's was, between two readings at this
# size: the program in bf16 reads 2.1e-4 to 2.5e-4 here (4 seeds), the fp8
# reference 2.6e-3 to 3.6e-3; 1e-3 lies 4x above the one, 2.6x below the other
TINY_LIMITS = {"served_logit_gap": 0.1, "served_logit_error": 1e-3}


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_fp8_control_is_not_correct(seed):
    """The reference in fp8 in the program's place, held to the cell's
    limits by the harness's own comparison, is not correct; the program's
    own readings on the same rows (noted under ``sound``) lie 3x inside
    the same limit."""
    notes = {}
    out = harness.run_cell(CELL, seed, 0.1, False, t_start=time.perf_counter(), device="cpu",
                           require_card=False, control=True, notes=notes, check_imports=False,
                           overrides={"config": TINY, "traffic": {**TINY_TRAFFIC, "limits": TINY_LIMITS}})
    assert out["correct"] is False
    error = out["checks"]["served_logit_error"]
    assert error["value"] == notes["control"]["fp8_served_logit_error"] > error["limit"] == 1e-3
    assert 0 < 3 * notes["sound"]["served_logit_error"] < error["limit"]
    assert all(c["value"] <= c["limit"] for n, c in out["checks"].items() if n != "served_logit_error")


def test_traced_readers_read_the_window():
    """Each of the cell's per-layer readers reads a number from a window's
    records (a device trace stood in by one kernel of each kind): the
    accepted serve readers and the cell's two own."""
    b = harness.load_json(harness.BENCH)
    names = [m["name"] for m in harness.per_layer_metrics(b, CELL)]
    assert names == ["decode_step_ms.serve", "mfu_pct.serve", "device_idle_pct.serve", "prefill_ms.granite",
                     "expert_gemm_roofline_pct.granite"]

    class _Traced:
        kernels = [("_ZN7cutlass13device_kernelI...GroupProblemShapeI...", 0.0, 0.45),
                   ("void at::cuda::detail::prepare_grouped_gemm_data<...>", 0.45, 0.5), ("other", 0.5, 1.0)]

    cell = harness.Cell(next(w for w in b["workloads"] if w["name"] == CELL), {}, {}, 1, 1.0, True, "cpu")
    cell.window, cell.traced = (0.0, 2.0), _Traced()
    cell.layer = {"window_s": 2.0, "busy_s": 1.0,
                  "serve": {"window_s": 2.0, "batches": 1, "batch_s": [2.0], "prefill_s": 0.5, "prefills": 1,
                            "decode_steps": 10, "model_flops": 9.89e12, "expert_bound_s": 0.25}}
    got = {n: harness.load_module(harness.HERE / "metrics" / f"{n}.py", "m").read(cell) for n in names}
    assert got == pytest.approx({"decode_step_ms.serve": 150.0, "prefill_ms.granite": 500.0,
                                 "mfu_pct.serve": 0.5, "device_idle_pct.serve": 50.0,
                                 "expert_gemm_roofline_pct.granite": 50.0})


def test_flops_of_the_cut():
    """The cut's frozen counts: active matmul parameters a token, and a
    32 x 2,048 prefill (~550 TFLOP: 8.4 GFLOP a token)."""
    config = json.loads((ROOT / "portbench/configs/granite-4.0-h-small.json").read_text())
    # 20 x 113,541,120 (router, 10 experts, shared) + 18 x 102,236,160
    # (in_proj, out_proj) + 2 x 41,943,040 (q, k, v, o)
    assert yardstick_layered.active_matmul_params(config) == 4194959360
    flops = yardstick_layered.prefill_flops(config, [2048] * 32)
    assert 540e12 < flops < 560e12
    # decode at batch 32 with 68 experts reached: bound by their weights' bytes
    assert yardstick_layered.expert_bound_s(config, 32, 68) == pytest.approx(68 * 3 * 4096 * 768 * 2 / 3.35e12
                                                                             + 320 * 4 * 4096 / 3.35e12)
    # prefill, four calls of 16,384 tokens: bound by the FLOPs
    assert yardstick_layered.expert_bound_s(config, 4 * 16384, 4 * 72) == pytest.approx(
        2 * 4 * 16384 * 10 * 3 * 4096 * 768 / 989e12)
    assert config["parameters"] == serve_layered.model_config(config).param_count() == 16309191936


def test_reference_and_driver_load_nothing_of_jax():
    """The reference loads nothing of the port; after the driver has run a
    tiny cell the process holds no module of JAX or of the JAX package."""
    import subprocess

    code = f"""
import sys, time, json
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import portbench.reference.granite_hybrid
assert not [m for m in sys.modules if m.split('.')[0] == 'repro_torch'], 'reference loads the port'
from portbench import harness
harness.run_cell({CELL!r}, 5, 0.1, False, t_start=time.perf_counter(), device='cpu', require_card=False,
                 overrides=json.loads({json.dumps({"config": TINY, "traffic": TINY_TRAFFIC})!r}))
print(harness.forbidden_modules())
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
