"""Read a cell's numbers beside its control's, seed by seed, on the card.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed: one run of the cell (a short window at the cell's own load
is enough), its numbers compared, and the driver's control readings (the
plain reference in the next precision below the configuration's, or with
one stated guarantee broken, in the program's place). One JSON line per
seed. The limits in the traffic files were set
from these readings; the benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    t_start = T_START
    for seed in args.seeds:
        notes = {}
        out = harness.run_cell(args.workload, seed, args.seconds, False, t_start=t_start,
                               control=True, notes=notes)
        print(json.dumps({"seed": seed, "correct": out["correct"], "metrics": out["metrics"],
                          "checks": out["checks"], "notes": notes}), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
