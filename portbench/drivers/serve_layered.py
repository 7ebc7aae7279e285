"""Serving driver of a ``layered`` stack (granitemoehybrid): batched greedy
generation through the port's ``build_model`` -> ``ServeEngine``, a closed
loop that keeps ``ahead`` batches of requests submitted beyond the one
being served, as the ``serve`` driver does for a dense model.

The model is built with its parameters uninitialised and each leaf is then
drawn on the device, layer by layer, from a generator of its own keyed by
the seed, its name and its layer (``leaf``), so no second copy of the
weights is ever made; the check draws the same leaves again, one layer at a
time, for the float32 reference (``reference/granite_hybrid.py``). The
warm-up serves the traffic's first batch, at its longest prompt, for two
tokens: a prefill and a decode step at the window's shapes.

The window runs whole batches: it closes at the end of the first batch
that finishes after ``seconds``. Beside the tokens a second it records the
prefill and decode times, the model FLOPs (``yardstick_layered``), the
least time of the window's expert layers (for the grouped GEMM's roofline)
and the model's routing counters over the window.

The check. In each batch the timed steps copy the logits of
``sample_requests`` probe rows (the request with the most tokens to serve,
the others drawn from the seed) into a buffer on the card, as they come
(``probe``). After the window the last batch's probe rows are run through
the reference over the sequences the engine processed (its left padding,
the prompt, the served tokens but the last), and at every served position
two numbers are taken: by how much the served token's float32 logit lies
below the reference's best (``served_logit_gap``), and the largest
difference between the program's logits and the reference's over the
whole vocabulary (``served_logit_error``). With random weights and the
published embedding multiplier the current token's own logit leads by a
wide margin, so the served tokens alone barely test the arithmetic; the
logits do.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict

import numpy as np
import torch

from portbench import inputs, yardstick_layered
from portbench.drivers.lm import flat

NORMS = ("ln1", "ln2", "ln_f", "norm", "D")


def model_config(config: dict):
    """The port's ``LayeredConfig`` for the configuration file (its
    published keys), with the file's ``program`` settings applied."""
    from repro_torch.config.model import LayeredConfig

    d, H = config["hidden_size"], config["num_attention_heads"]
    assert config["mamba_n_groups"] == 1 and config["mamba_expand"] * d == config["mamba_n_heads"] * \
        config["mamba_d_head"], "one group of heads spanning d_inner"
    assert config["position_embedding_type"] == "nope" and not config["attention_bias"]
    assert config["mamba_conv_bias"] and not config["mamba_proj_bias"]
    cfg = LayeredConfig(
        name=config["name"], family="layered", n_layers=config["num_hidden_layers"], d_model=d, n_heads=H,
        n_kv_heads=config["num_key_value_heads"], head_dim=d // H, d_ff=config["intermediate_size"],
        vocab_size=config["vocab_size"], rope_theta=0.0, n_experts=config["num_local_experts"],
        experts_per_token=config["num_experts_per_tok"], ssm_state=config["mamba_d_state"],
        ssm_conv=config["mamba_d_conv"], ssm_expand=config["mamba_expand"], ssm_version=2,
        ssm_head_dim=config["mamba_d_head"], ssm_chunk=config["mamba_chunk_size"],
        tie_embeddings=config["tie_word_embeddings"], norm_eps=config["rms_norm_eps"],
        dtype=config["torch_dtype"], layer_types=tuple(config["layer_types"]),
        shared_d_ff=config["shared_intermediate_size"], embedding_multiplier=config["embedding_multiplier"],
        residual_multiplier=config["residual_multiplier"], attn_scale=config["attention_multiplier"],
        logits_scaling=config["logits_scaling"])
    return dataclasses.replace(cfg, **config.get("program", {}))


def leaf(seed: int, name: str, index, shape, device) -> torch.Tensor:
    """One layer's slice (``index``; None for an unstacked leaf) of the
    parameter ``name``, float32, from a generator of its own: norm scales
    and D 1 + N(0, 0.02); A_log and dt_bias as Mamba-2 initialises them
    (A in [-16, -1], dt log-uniform in [1e-3, 0.1]); every other leaf
    N(0, 0.02)."""
    g = inputs.torch_generator(seed, f"layered|{name}|{index}", device)
    last = name.rsplit(".", 1)[-1]
    if last == "A_log":
        return torch.log(1.0 + 15.0 * torch.rand(shape, generator=g, device=device))
    if last == "dt_b":
        u = torch.rand(shape, generator=g, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp_min(1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    w = torch.randn(shape, generator=g, device=device) * 0.02
    return w + 1.0 if last in NORMS else w


def _stacked(name: str) -> bool:
    return name.split(".", 1)[0] in ("layers", "mamba", "attn")


def build(cell):
    """The program's config and model on the cell's device, each leaf drawn
    into its parameter (no other copy of the weights is made)."""
    from repro_torch.models import build_model

    cfg = model_config(cell.config)
    model = build_model(cfg, cell.device, init=False)
    with torch.no_grad():
        for name, p in flat(model.params()).items():
            if _stacked(name):
                for i in range(p.shape[0]):
                    p[i].copy_(leaf(cell.seed, name, i, p.shape[1:], cell.device))
            else:
                p.copy_(leaf(cell.seed, name, None, p.shape, cell.device))
    return cfg, model


def reference_weights(cell):
    """(top, layer_weights) for the reference: the same leaves drawn again,
    rounded to the type the program holds each in and widened to float32;
    ``layer_weights(i)`` draws layer i's when called."""
    from repro_torch.models.model import param_specs

    cfg = model_config(cell.config)
    specs = flat(param_specs(cfg))
    dev = cell.device

    def draw(name, index):
        s = specs[name]
        shape = s.shape[1:] if index is not None else s.shape
        return leaf(cell.seed, name, index, shape, dev).to(s.dtype).float()

    top = {n: draw(n, None) for n in specs if not _stacked(n)}

    def layer_weights(i: int) -> Dict[str, torch.Tensor]:
        kind = "mamba" if cfg.layer_types[i] == "mamba" else "attn"
        j = cfg.mixer_index(i)
        w = {n.split(".", 1)[1]: draw(n, i) for n in specs if n.startswith("layers.")}
        w.update({n: draw(n, j) for n in specs if n.startswith(kind + ".")})
        return w

    return top, layer_weights


class Probe:
    """The logits of a batch's probe rows, copied on the card at each
    timed step into one buffer (step, probe row, vocabulary)."""

    def __init__(self, steps: int, rows: int, vocab: int, device) -> None:
        self.buf = torch.empty((steps, rows, vocab), dtype=torch.float32, device=device)
        self.rows = None      # device index of the probe rows in the batch
        self.step = 0

    def start(self, rows) -> None:
        self.rows = torch.as_tensor(rows, device=self.buf.device)
        self.step = 0

    def take(self, logits: torch.Tensor) -> None:
        if self.rows is not None:
            self.buf[self.step].copy_(logits.index_select(0, self.rows))
            self.step += 1


def probe_rows(cell, news, batch_no: int):
    """Rows of a batch to probe: the one with the most tokens to serve and
    ``sample_requests`` - 1 others drawn from the seed."""
    longest = int(np.argmax(news))
    rest = [i for i in inputs.rng(cell.seed, "probe", batch_no).permutation(len(news)).tolist()
            if i != longest]
    return [longest] + rest[:cell.traffic["sample_requests"] - 1]


def setup(cell):
    from repro_torch.serving.engine import Request, ServeEngine

    t = cell.traffic
    cfg, model = build(cell)
    engine = ServeEngine(model, max_batch=t["max_batch"])
    requests = inputs.serve_requests(cell.seed, t["batches"], t["max_batch"], t["prompt"], t["output"],
                                     cell.config["vocab_size"], t["zipf_a"])
    # warm-up: the first batch, at the traffic's longest prompt, two tokens
    longest = max(len(p) for p, _ in requests)
    first = sorted(requests[:t["max_batch"]], key=lambda r: -len(r[0]))
    for i, (prompt, _) in enumerate(first):
        if not i:
            prompt = (prompt * -(-longest // len(prompt)))[:longest]
        engine.submit(Request(f"warm{i}", prompt, max_new_tokens=2))
    engine.run()
    cell.sync()

    orig_prefill, orig_decode = model.prefill, model.decode_step
    timing = {"prefill_s": 0.0, "prefills": 0, "decode_steps": 0}
    probe = Probe(t["output"]["max"], t["sample_requests"], cfg.vocab_size, cell.device)

    def prefill(*a, **kw):
        t0 = time.perf_counter()
        with cell.span("serve.prefill"):
            out = orig_prefill(*a, **kw)
            probe.take(out[0])
            cell.sync()
        timing["prefill_s"] += time.perf_counter() - t0
        timing["prefills"] += 1
        return out

    def decode_step(*a, **kw):
        with cell.span("serve.decode_step"):
            out = orig_decode(*a, **kw)
            probe.take(out[0])
        timing["decode_steps"] += 1
        return out

    model.prefill, model.decode_step = prefill, decode_step
    return {"model": model, "engine": engine, "requests": requests, "timing": timing, "Request": Request,
            "counters": model.moe_counters(), "probe": probe}


def measure(cell, s):
    t = cell.traffic
    engine, requests, Request, timing = s["engine"], s["requests"], s["Request"], s["timing"]
    c = cell.config
    B = t["max_batch"]
    submitted = taken = missing = 0
    done = []   # (request index, served tokens, padded prompt length of its batch)
    unfinished = 0
    cell.sync()
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    prefill_flops = decode_flops = 0
    batch_s = []
    while True:
        while submitted - len(done) < (1 + t["ahead"]) * B:
            prompt, new = requests[submitted % len(requests)]
            engine.submit(Request(str(submitted), prompt, max_new_tokens=new))
            submitted += 1
        batch = [requests[i % len(requests)] for i in range(taken, min(taken + B, submitted))]
        rows = probe_rows(cell, [new for _, new in batch], len(batch_s))
        s["probe"].start(rows)
        b0 = time.perf_counter()
        with cell.span("serve.batch"):
            results = engine.step()
        batch_s.append(time.perf_counter() - b0)
        due = set(range(taken, taken + min(B, submitted - taken)))
        taken += len(due)
        missing += len(due - {int(r.request_id) for r in results})
        P = max(r.prompt_len for r in results)
        lens = [r.prompt_len for r in results]
        news = [requests[int(r.request_id) % len(requests)][1] for r in results]
        unfinished += sum(1 for r, new in zip(results, news) if len(r.tokens) != new)
        prefill_flops += yardstick_layered.prefill_flops(c, lens)
        for j in range(1, max(news)):
            decode_flops += yardstick_layered.decode_flops(c, [n + j for n, m in zip(lens, news) if j < m])
        done.extend((int(r.request_id), r.tokens, P) for r in results)
        last = [(int(results[i].request_id), results[i].tokens, P) for i in rows]
        if time.perf_counter() >= deadline:
            break
    cell.sync()
    t1 = time.perf_counter()
    cell.window = (t0, t1)
    served = sum(len(tok) for _, tok, _ in done)
    cell.attempted = len(done)
    cell.failed = unfinished + missing
    s["missing"] = missing
    cell.e2e["serve_tokens_per_s"] = served / (t1 - t0)
    after = s["model"].moe_counters()
    before = s["counters"]
    counters = {"moe_pairs_routed": after["moe_pairs_routed"] - before["moe_pairs_routed"],
                "moe_pairs_dropped": after["moe_pairs_dropped"] - before["moe_pairs_dropped"],
                "moe_max_expert_share": after["moe_max_expert_share"]}
    for key in ("expert_gemm_calls", "expert_tokens", "experts_used"):
        counters[key] = {ph: after[key][ph] - before[key][ph] for ph in after[key]}
    # the expert layers' least time, from the tokens each phase's calls took
    # and the experts their pairs reached (counted on the device)
    expert_bound_s = sum(yardstick_layered.expert_bound_s(c, counters["expert_tokens"][ph],
                                                          counters["experts_used"][ph])
                         for ph in counters["expert_tokens"])
    s["counters"] = counters
    notes = cell.layer.setdefault("notes", {})
    notes["batch_s"] = [round(x, 3) for x in batch_s]
    notes["counters"] = counters
    cell.layer["serve"] = {"window_s": t1 - t0, "batches": len(batch_s), "batch_s": batch_s,
                           "prefill_s": timing["prefill_s"], "prefills": timing["prefills"],
                           "decode_steps": timing["decode_steps"],
                           "model_flops": prefill_flops + decode_flops, "served_tokens": served,
                           "expert_bound_s": expert_bound_s}
    s["last"] = last


def release(cell, s):
    return {"last": s["last"], "requests": s["requests"], "missing": s["missing"],
            "counters": s["counters"], "probe": s["probe"].buf}


def rows_of(s, device):
    """The probe rows of the window's last batch: the sequence the engine
    processed (left padding with id 0, the prompt, the served tokens but
    the last), the served tokens, the position whose logits chose the
    first of them, and the program's logits at the served positions."""
    n = len(s["requests"])
    rows = []
    for slot, (i, tok, P) in enumerate(s["last"]):
        prompt = s["requests"][i % n][0]
        seq = [0] * (P - len(prompt)) + list(prompt) + list(tok[:-1])
        rows.append({"tokens": torch.as_tensor(seq, device=device), "served": list(tok), "first": P - 1,
                     "logits": s["probe"][:len(tok), slot]})
    return rows


def compare(rows, ref, got=None):
    """(largest gap, largest error) over every served position of the
    rows: how far the served token's reference logit lies below the
    reference's best, and the largest difference over the vocabulary
    between ``got`` (per row; default: the program's logits) and the
    reference's ``ref``. With ``got``, its first choice takes the served
    token's place in the gap."""
    gap = err = 0.0
    for k, (row, want) in enumerate(zip(rows, ref)):
        n = len(row["served"])
        want = want[:n]
        have = (row["logits"] if got is None else got[k][:n]).to(want.device)
        chosen = (torch.as_tensor(row["served"], device=want.device) if got is None
                  else have.argmax(-1))
        gap = max(gap, float((want.max(-1).values - want.gather(-1, chosen[:, None].long())[:, 0]).max()))
        err = max(err, float((have - want).abs().max()))
    return gap, err


def check(cell, s):
    from portbench.reference import granite_hybrid

    granite_hybrid.no_tf32()
    s["top"], s["layer_weights"] = reference_weights(cell)
    s["rows"] = rows_of(s, cell.device)
    toks, starts = [r["tokens"] for r in s["rows"]], [r["first"] for r in s["rows"]]
    with torch.no_grad():
        s["ref"] = granite_hybrid.logits(s["top"], s["layer_weights"], cell.config, toks, starts)
    gap, err = compare(s["rows"], s["ref"])
    cell.layer.setdefault("notes", {})["served"] = {
        "checked_tokens": sum(len(r["served"]) for r in s["rows"]),
        "padded_lengths": [len(r["tokens"]) for r in s["rows"]],
        "distinct_served_tokens": len({t for r in s["rows"] for t in r["served"]})}
    limits = cell.traffic["limits"]
    cell.check("served_logit_gap", gap, limits["served_logit_gap"])
    cell.check("served_logit_error", err, limits["served_logit_error"])
    cell.check("unfinished_requests", cell.failed - s["missing"], 0)
    cell.check("missing_requests", s["missing"], 0)
    cell.check("moe_pairs_dropped", s["counters"]["moe_pairs_dropped"], 0)


def control(cell, s):
    """The control: the reference in fp8 in the program's place, on the
    same rows, held to the cell's own limits in place of the program's
    readings (which move to the notes, under ``sound``): the gap of the
    token it puts first, and its logits' largest difference from the
    float32 reference's."""
    from portbench.reference import granite_hybrid

    toks, starts = [r["tokens"] for r in s["rows"]], [r["first"] for r in s["rows"]]
    with torch.no_grad():
        fp8 = granite_hybrid.logits(s["top"], s["layer_weights"], cell.config, toks, starts, "fp8")
    gap, err = compare(s["rows"], s["ref"], fp8)
    notes = cell.layer.setdefault("notes", {})
    notes["sound"] = {n: v for n, v, _ in cell.checks if n.startswith("served_logit")}
    notes["control"] = {"fp8_served_logit_gap": gap, "fp8_served_logit_error": err}
    cell.checks = [c for c in cell.checks if not c[0].startswith("served_logit")]
    limits = cell.traffic["limits"]
    cell.check("served_logit_gap", gap, limits["served_logit_gap"])
    cell.check("served_logit_error", err, limits["served_logit_error"])
