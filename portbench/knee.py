"""The knee of an open-loop cell, found once by a sweep of offered rates.

    python3 portbench/knee.py --workload wiki500k-online --seed <n> --seconds 10 \
        [--config xrlinear-wiki500k --traffic online]

Builds the cell's model and program once, serves its traffic at a rate far
below capacity (the unloaded latency), sets the latency limit from that,
then serves each rate of the sweep for ``--seconds``.  The knee is the
highest rate at which, like every lower rate of the sweep, the 95th
percentile stays under the limit and the backlog does not grow (the queue
left at the window's end drains within the limit).  The last line is a JSON
object with the sweep, the limit and its reason, the knee and the cell's
rate (0.8 of the knee), for the cell's file ``cells/<cell>.json``.  A cell
that ``BENCHMARK.json`` does not declare yet is named with its
configuration and mix.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

FRACTIONS = (0.5, 0.6, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95, 1.0)  # of the capacity the unloaded service time gives
UNLOADED_RATE = 20.0  # requests/s, far below capacity
LIMIT_FACTOR = 10.0  # the p95 limit, in unloaded p50s
SHARE = 0.8  # the cell's rate, as a share of the knee


def serve_at(cell, model, program, seed, device, rate, seconds):
    cell.mix["rate_per_s"] = rate
    loop = harness.OpenLoop(cell, model, program, seed, device, lambda s: None, seconds)
    rec = loop.window(seconds, harness.Sampler(seed, 0))
    lat = loop.latencies(rec) * 1e3
    ends = rec["end"][np.isfinite(rec["end"])]
    service = rec["service"][np.isfinite(rec["service"])] * 1e3
    return {
        "rate_per_s": rate,
        "requests": len(lat),
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "drain_ms": float(max(ends.max() - rec["t0"] - seconds, 0.0) * 1e3),
        "service_mean_ms": float(service.mean()),
        "service_p50_ms": float(np.percentile(service, 50)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--config", help="the configuration of a cell BENCHMARK.json does not declare")
    ap.add_argument("--traffic", help="its traffic mix")
    args = ap.parse_args(argv)
    harness.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("knee: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    entry = None
    if args.config:
        entry = {"name": args.workload, "config": args.config, "traffic": args.traffic, "chips": 1}
    cell = harness.Cell(args.workload, entry=entry)
    models = cell.module()
    model = models.Model(cell.cfg, args.seed, device)
    program = models.Program(model, device)
    print(f"knee: {args.workload}, card {harness.card_line(device)}; set-up {time.perf_counter() - T_START!r} s")
    unloaded = serve_at(cell, model, program, args.seed, device, UNLOADED_RATE, args.seconds)
    print(f"unloaded: {unloaded}")
    limit = LIMIT_FACTOR * unloaded["p50_ms"]
    capacity = 1e3 / unloaded["service_mean_ms"]
    sweep = []
    for f in FRACTIONS:
        row = serve_at(cell, model, program, args.seed, device, round(f * capacity, 1), args.seconds)
        row["ok"] = row["p95_ms"] <= limit and row["drain_ms"] <= limit
        print(f"sweep: {row}")
        sys.stdout.flush()
        sweep.append(row)
    knee = None
    for row in sweep:
        if not row["ok"]:
            break
        knee = row["rate_per_s"]
    out = {
        "card": harness.card_line(device),
        "unloaded": unloaded,
        "limit_ms": limit,
        "limit_reason": f"{LIMIT_FACTOR:g} times the unloaded batch-1 p50: an online user waits at most an order "
                        "of magnitude more than on an idle server, short of the queue's cliff near capacity",
        "capacity_per_s": capacity,
        "sweep": sweep,
        "knee_per_s": knee,
        "rate_per_s": None if knee is None else round(SHARE * knee),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
