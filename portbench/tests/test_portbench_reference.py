"""The plain references against the port at small sizes on the CPU, and
the controls: the reference in the program's place with its precision one
step below the configuration's, or with a stated guarantee broken, comes
out as not correct."""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import harness, inputs  # noqa: E402
from portbench.drivers import lm  # noqa: E402
from portbench.reference import deid, qwen2  # noqa: E402
from portbench_staged import bench  # noqa: E402

TINY_LM = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
           "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 256}
TINY_CT = {"config": {"slices_per_study": 24,
                      "catalog": {"accessions": 4, "instances_per_accession": 512, "block_rows": 512,
                                  "columns": 11}},
           "traffic": {"payload_sample_block": 8}}


class _Cell:
    def __init__(self, config, seed=3):
        self.config, self.seed, self.device = config, seed, torch.device("cpu")


def _lm_config(**over):
    config = json.loads((ROOT / "portbench/configs/qwen2-0.5b.json").read_text())
    config.update(TINY_LM)
    config.update(over)
    return config


@pytest.mark.parametrize("shape,dtype,top", [((64, 80), np.uint16, 4095), ((33, 17), np.uint8, 255),
                                             ((40, 40), np.uint16, 65535)])
def test_encoder_matches_the_port_codec(shape, dtype, top):
    from repro_torch.dicom import codec

    r = np.random.default_rng(1)
    img = (r.random(shape) * top).astype(dtype)
    img[:4] = 0                     # long zero runs, and escapes after them
    assert deid.encode(img) == codec.encode(img, 1)


def test_blank_matches_the_port():
    from repro_torch.core.scrub import numpy_blank

    img = np.arange(64 * 48, dtype=np.uint16).reshape(64, 48)
    rects = [(40, 0, 20, 5), (-5, -5, 3, 3), (0, 60, 48, 10), (10, 10, 0, 4)]
    assert np.array_equal(deid.blank(img, rects), numpy_blank(img, rects))


@pytest.mark.parametrize("recompress", [True, False])
def test_tags_and_pseudonyms_match_the_port(recompress):
    from repro_torch.core import scripts
    from repro_torch.core.anonymize import AnonymizerStage
    from repro_torch.core.pipeline import build_request
    from repro_torch.core.pseudonym import PseudonymService
    from repro_torch.dicom.dataset import DicomDataset

    config = json.loads((ROOT / "portbench/configs/ct_request.json").read_text())
    tags = inputs.ct_study_tags(11, "ACC00010", 20210104, config["device"], 3)
    key = inputs.rng(11, "protocol-key", 0).bytes(32)
    svc = PseudonymService("IRB-000", key=key)
    req = build_request(svc, "ACC00010", tags["mrn"])
    pseudo = deid.pseudonyms(key, "IRB-000", "ACC00010", tags["mrn"])
    assert (pseudo["accession"], pseudo["mrn"], pseudo["jitter"]) == (req.anon_accession, req.anon_mrn,
                                                                      req.jitter)
    stage = AnonymizerStage(scripts.DEFAULT_ANONYMIZER_SCRIPT)
    for el in tags["instances"]:
        ds = DicomDataset(elements=dict(el), private=dict(tags["private"]))
        if recompress:
            ds["TransferSyntaxUID"] = deid.JPEG_LOSSLESS
        out = stage(ds, req.script_params()).dataset
        assert out.elements == deid.anonymize(el, pseudo, recompress) and not out.private


def test_lm_reference_matches_the_port_in_f32():
    """Prefill logits of the port's model with float32 activations on the
    same (bf16-valued) weights: equal to float32 rounding (1e-4 relative:
    the two sum in different orders)."""
    cell = _Cell(_lm_config(torch_dtype="float32"))
    cfg, model = lm.build(cell)
    w = lm.reference_weights(cell)
    rcfg = lm.reference_config(cell.config)
    r = inputs.rng(3, "t")
    toks = torch.as_tensor(inputs.zipf_tokens(r, (2, 32), TINY_LM["vocab_size"], 1.3))
    got, _ = model.prefill({"tokens": toks})
    want = qwen2.logits(w, rcfg, toks)[:, -1]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_serve_requests_draw_each_batch_from_the_seed():
    """Each batch draws lengths of its own from the traffic's distributions,
    one in each stratum; the seed changes them; the medians are the source's."""
    t = json.loads((ROOT / "portbench/traffic/qwen2-0.5b.serve.json").read_text())
    reqs = inputs.serve_requests(2**31 + 7, 6, 32, t["prompt"], t["output"], 151936, t["zipf_a"])
    prompts = np.array([len(p) for p, _ in reqs]).reshape(6, 32)
    outs = np.array([o for _, o in reqs]).reshape(6, 32)
    assert len({tuple(row) for row in prompts}) == 6 and len({tuple(row) for row in outs}) == 6
    assert prompts.min() >= t["prompt"]["min"] and prompts.max() <= t["prompt"]["max"]
    assert outs.min() >= t["output"]["min"] and outs.max() <= t["output"]["max"]
    for lens, d in ((prompts, t["prompt"]), (outs, t["output"])):
        # stratified: the batch's sorted lengths sit in the quantile bins
        z = np.sort(np.log(np.clip(lens, d["min"] + 1, d["max"] - 1) / d["median"]) / d["sigma"], axis=1)
        assert abs(np.median(lens) / d["median"] - 1) < 0.05
        assert np.all(z[:, 15] < 0.05) and np.all(z[:, 16] > -0.05)
    other = inputs.serve_requests(2**31 + 8, 6, 32, t["prompt"], t["output"], 151936, t["zipf_a"])
    assert [len(p) for p, _ in other] != [len(p) for p, _ in reqs]


def test_serve_control_is_not_correct():
    """Full width and vocabulary, two layers: the served tokens of the
    port in bf16 sit within the limit of the float32 reference's best; the
    tokens the reference in fp8 would put first do not."""
    notes = {}
    out = harness.run_cell("qwen2-0.5b.serve", 8, 0.1, False, t_start=time.perf_counter(), device="cpu",
                           require_card=False, control=True, notes=notes, check_imports=False,
                           overrides={"config": {"num_hidden_layers": 2},
                                      "traffic": {"max_batch": 2, "batches": 4,
                                                  "prompt": {"median": 12, "sigma": 0.6, "min": 4,
                                                             "max": 32},
                                                  "output": {"median": 16, "sigma": 0.6, "min": 8,
                                                             "max": 24},
                                                  "sample_requests": 2}})
    limit = out["checks"]["served_logit_gap"]["limit"]
    assert out["correct"] and out["checks"]["served_logit_gap"]["value"] <= limit
    assert notes["control"]["fp8_served_logit_gap"] > limit


@pytest.mark.parametrize("workload", ["ct_request.cold", "ct_request.scrub"])
def test_deid_control_is_not_correct(workload):
    """The reference with the burned-in regions left unblanked, in the
    program's place, mismatches every delivered instance."""
    notes = {}
    out = harness.run_cell(workload, 13, 0.5, False, t_start=time.perf_counter(), device="cpu",
                           require_card=False, control=True, notes=notes, check_imports=False,
                           overrides=TINY_CT, bench=bench())
    assert out["correct"]
    ctl = notes["control"]
    assert ctl["compared"] > 0 and ctl["unblanked_pixel_mismatches"] == ctl["compared"]
    assert ctl["unblanked_pixel_mismatches"] > out["checks"]["pixel_mismatches"]["limit"]
