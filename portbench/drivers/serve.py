"""Serving driver: batched greedy generation through the port's
``ServeEngine``, a closed loop that keeps ``ahead`` batches of requests
submitted beyond the one being served.

Each request has a prompt and a number of tokens to generate, both drawn
from the seed (``inputs.serve_requests``: each batch its own lengths from
the traffic's distributions); the requests repeat once all have been sent.
The window runs whole batches: it closes at the end of the first batch that
finishes after ``seconds``, and the rate counts the generated tokens of
every request completed in it over its whole length. After the window a
sample of the completed requests, the longest among them, is run through
the plain float32 reference over the sequence the engine processed (its
left padding, the prompt, the served tokens), and each served token's
logit is held against the reference's best at that position.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, yardstick
from portbench.drivers import lm


def setup(cell):
    from repro_torch.serving.engine import Request, ServeEngine

    t = cell.traffic
    cfg, model = lm.build(cell)
    engine = ServeEngine(model, max_batch=t["max_batch"])
    requests = inputs.serve_requests(cell.seed, t["batches"], t["max_batch"], t["prompt"], t["output"],
                                     cell.config["vocab_size"], t["zipf_a"])
    # warm-up: one full batch at the longest prompt the traffic holds
    longest = max(len(p) for p, _ in requests)
    for i in range(t["max_batch"]):
        engine.submit(Request(f"warm{i}", requests[0][0][:1] * longest, max_new_tokens=2))
    engine.run()
    cell.sync()

    orig_prefill, orig_decode = model.prefill, model.decode_step
    timing = {"prefill_s": 0.0, "decode_steps": 0}

    def prefill(*a, **kw):
        t0 = time.perf_counter()
        with cell.span("serve.prefill"):
            out = orig_prefill(*a, **kw)
            cell.sync()
        timing["prefill_s"] += time.perf_counter() - t0
        return out

    def decode_step(*a, **kw):
        with cell.span("serve.decode_step"):
            out = orig_decode(*a, **kw)
        timing["decode_steps"] += 1
        return out

    model.prefill, model.decode_step = prefill, decode_step
    return {"model": model, "engine": engine, "requests": requests, "timing": timing, "Request": Request}


def measure(cell, s):
    t = cell.traffic
    engine, requests, Request, timing = s["engine"], s["requests"], s["Request"], s["timing"]
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
            # the requests repeat in order once all have been sent
            prompt, new = requests[submitted % len(requests)]
            engine.submit(Request(str(submitted), prompt, max_new_tokens=new))
            submitted += 1
        b0 = time.perf_counter()
        with cell.span("serve.batch"):
            results = engine.step()
        batch_s.append(time.perf_counter() - b0)
        # the engine takes the oldest requests first, up to a batch: each of
        # them is due in this step's results
        due = set(range(taken, taken + min(B, submitted - taken)))
        taken += len(due)
        missing += len(due - {int(r.request_id) for r in results})
        P = max(r.prompt_len for r in results)
        lens = [r.prompt_len for r in results]
        news = [requests[int(r.request_id) % len(requests)][1] for r in results]
        unfinished += sum(1 for r, new in zip(results, news) if len(r.tokens) != new)
        prefill_flops += yardstick.prefill_flops(cell.config, lens)
        for j in range(1, max(news)):
            decode_flops += yardstick.decode_flops(cell.config, [n + j for n, m in zip(lens, news)
                                                                 if j < m])
        done.extend((int(r.request_id), r.tokens, P) for r in results)
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
    cell.layer.setdefault("notes", {})["batch_s"] = [round(x, 3) for x in batch_s]
    cell.layer["serve"] = {"window_s": t1 - t0, "batches": len(batch_s), "batch_s": batch_s,
                           "prefill_s": timing["prefill_s"], "decode_steps": timing["decode_steps"],
                           "model_flops": prefill_flops + decode_flops, "served_tokens": served}
    s["done"] = done


def release(cell, s):
    return {"done": s["done"], "requests": s["requests"], "missing": s["missing"]}


def sample(cell, done):
    """The request with the longest processed sequence, and others drawn
    from the seed; ``done`` holds (index, served tokens, padded length,
    prompt)."""
    longest = max(range(len(done)), key=lambda i: (done[i][2] + len(done[i][1]), len(done[i][3])))
    r = inputs.rng(cell.seed, "serve-sample")
    rest = [i for i in r.permutation(len(done)).tolist() if i != longest]
    return [longest] + rest[:cell.traffic["sample_requests"] - 1]


def rows_for(cell, s, device):
    """The sequences the engine processed for the sampled requests: its left
    padding (id 0), the prompt, the served tokens but the last."""
    n = len(s["requests"])
    done = [(i, tok, P, s["requests"][i % n][0]) for i, tok, P in s["done"]]
    rows = []
    for k in sample(cell, done):
        i, tok, P, prompt = done[k]
        seq = [0] * (P - len(prompt)) + list(prompt) + list(tok[:-1])
        rows.append({"tokens": torch.as_tensor(seq, device=device), "served": list(tok), "first": P - 1})
    return rows


def check(cell, s):
    from portbench.reference import qwen2

    qwen2.no_tf32()
    s["w"] = lm.reference_weights(cell)
    s["rcfg"] = lm.reference_config(cell.config)
    s["rows"] = rows_for(cell, s, cell.device)
    gaps = qwen2.served_gaps(s["w"], s["rcfg"], s["rows"])
    cell.layer.setdefault("notes", {})["served"] = {
        "checked_tokens": len(gaps), "gaps_above_0": int(np.sum(np.array(gaps) > 0)),
        "padded_lengths": [len(r["tokens"]) for r in s["rows"]]}
    cell.check("served_logit_gap", float(np.max(gaps)), cell.traffic["limits"]["served_logit_gap"])
    cell.check("unfinished_requests", cell.failed - s["missing"], 0)
    cell.check("missing_requests", s["missing"], 0)


def control(cell, s):
    """The control: at each served position of the same rows, the gap of
    the token that the reference in fp8 puts first."""
    from portbench.reference import qwen2

    gaps = qwen2.served_gaps(s["w"], s["rcfg"], s["rows"], pick="fp8")
    cell.layer.setdefault("notes", {})["control"] = {"fp8_served_logit_gap": float(np.max(gaps))}
