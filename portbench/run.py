"""One run of one benchmark cell of the PyTorch/CUDA port on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the checks on standard error and
the result as one JSON line, last on standard output; exits non-zero and
prints no result without a card, with too few cards, or where a module of
JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
