"""Platform integration on the PyTorch port: de-identified imaging -> VLM
training batches.

    PYTHONPATH=src python examples/deid_to_training_torch.py [--device cpu]

The STARR story end to end (paper Background + Future Work): the pipeline
de-identifies studies into the researcher bucket, and a downstream
imaging-AI job consumes the *scrubbed* pixels — via the frozen-vision-tower
stub — to train the llava-family backbone (reduced: 34 B parameters do not
train on one card). The PHI boundary is explicit: the training side only
ever touches post-scrub datasets. De-identification (``recompress=False``:
the scrub kernel), the burned-in-text audit (the phi_detect kernel) and the
train steps run on ``--device`` (default the card, ``cuda:0``; ``cpu``: the
kernels' plain PyTorch versions). The weights are drawn on the host from a
seed, so the card and the CPU start from the same ones.
"""
import argparse

import numpy as np
import torch

from repro_torch.config.registry import get_arch
from repro_torch.core import DeidPipeline, PseudonymService, TrustMode, build_request
from repro_torch.device import resolve_device
from repro_torch.dicom.generator import StudyGenerator
from repro_torch.kernels.phi_detect.ops import audit_dataset
from repro_torch.launch.train import batch_to_device
from repro_torch.models import build_model
from repro_torch.training import cosine_schedule, make_train_step, train_state_init
from repro_torch.training.data import DeidImagePipeline


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises before any work without the card

    # --- de-identify a small US+CT corpus (US = heaviest burn-in, paper Table 2)
    gen = StudyGenerator(11)
    pseudo = PseudonymService("IRB-IMG", TrustMode.POST_IRB, key=b"i" * 32)
    pipe = DeidPipeline(recompress=False, device=device)
    delivered = []
    for i in range(6):
        s = gen.gen_study(f"IMG{i:03d}", modality="US" if i % 2 else "CT", n_images=2)
        outs, manifest = pipe.process_study(s, build_request(pseudo, s.accession, s.mrn))
        delivered.extend(outs)
    print(f"de-identified corpus: {len(delivered)} instances")

    # --- PHI audit gate (Future Work: ML detection) before training sees pixels
    # audit_dataset thresholds at the stored bit depth (12-bit CT in u16 words)
    flagged = [d for d in delivered if audit_dataset(d, device=device)]
    assert not flagged, "post-scrub corpus must pass the burned-in-text audit"
    print("phi_detect audit: clean")

    # --- build VLM batches from scrubbed pixels
    cfg = get_arch("llava-next-34b").reduced()
    model = build_model(cfg, device, generator=torch.Generator().manual_seed(0))
    data = DeidImagePipeline(cfg, seed=3)
    batch = batch_to_device(
        data.batch_from_datasets(delivered, batch=4, seq=128, rng=np.random.default_rng(0)), device)

    # --- a few train steps on the backbone
    state = train_state_init(model)
    step_fn = make_train_step(model, cosine_schedule(1e-3, 5, 100))
    losses = []
    for _ in range(args.steps):
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    print(f"VLM backbone loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps on {device}")
    assert losses[-1] < losses[0]
    print("de-id -> training integration OK")
    return {"delivered": delivered, "flagged": len(flagged), "losses": losses, "device": str(device)}


if __name__ == "__main__":
    main()
