"""Readings of a cell's control: the port's own float16 query wire in place
of the float32 one the configuration states, at the cell's own size and load.

    python3 portbench/control.py --workload <cell> --seconds 5 --seeds <n> <n> <n>

Each seed is a whole run of the cell with the control switched on (set-up,
a short window, the comparison); a line per seed gives the numbers compared
beside the cell's limits.  The control has to come out as not correct; the
benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402  (after the path above)

CONTROL_WIRE = "float16"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False, torch.device("cuda", 0), time.perf_counter(),
                               wire=CONTROL_WIRE, log=lambda s: None)
        print(json.dumps({"workload": args.workload, "seed": seed, "wire": CONTROL_WIRE, "correct": res["correct"],
                          "checks": res["checks"]}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
