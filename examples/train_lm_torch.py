"""Train a ~20M-param reduced LM for a few hundred steps on the PyTorch port.

    PYTHONPATH=src python examples/train_lm_torch.py [--arch qwen2-0.5b] [--steps 200] [--device cpu]

Uses the port's train loop (repro_torch.launch.train): AdamW + cosine
schedule, checkpoint every 50 steps, resumable with --resume. Runs on
``--device`` (default the card, ``cuda:0``; ``cpu`` runs the same PyTorch
code on the host).
"""
import argparse

from repro_torch.launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    argv = [
        "--arch", args.arch,
        "--steps", str(args.steps),
        "--batch", "8",
        "--seq", "128",
        "--lr", "1e-3",
        "--ckpt-every", "50",
        "--ckpt-dir", args.ckpt_dir,
        "--device", args.device,
    ]
    if args.resume:
        argv.append("--resume")
    result = train.main(argv)
    print(f"final loss: {result['final_loss']:.4f} after {result['steps']} steps on {result['device']}")
    # uniform baseline is ln(512) ~= 6.24; the default 200 steps lands well below
    threshold = 6.2 if args.steps < 150 else 6.0
    assert result["final_loss"] < threshold, "training should beat the uniform baseline"
    return result


if __name__ == "__main__":
    main()
