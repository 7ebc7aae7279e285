"""Serve a small LM with batched requests on the PyTorch port.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch qwen2-0.5b] [--device cpu]

The model and the engine run on ``--device`` (default the card, ``cuda:0``;
``cpu`` runs the same PyTorch code on the host).
"""
import argparse

from repro_torch.launch import serve


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    result = serve.main(["--arch", args.arch, "--requests", str(args.requests), "--max-new", "12",
                         "--device", args.device])
    print(f"served {result['requests']} requests / {result['tokens']} tokens in "
          f"{result['seconds']:.2f}s on {result['device']}")
    assert result["requests"] == args.requests


if __name__ == "__main__":
    main()
