"""Where a closed-loop cell's calls spend the time that makes some slow.

    python3 portbench/noise.py --workload wiki500k-batch --seed <n> --calls 60

Builds the cell as a run does, makes ``--calls`` calls unprofiled (the
spread as the window sees it), then as many again each under ``cProfile``,
with the garbage collector's pauses timed.  It compares the slowest tenth of
the profiled calls with the fastest tenth: the functions whose own time
(``tottime``) grew most between them name the source of the spread.  The
last line is a JSON object with both spreads and that table.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import cProfile  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pstats  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

TOP = 15


def quartiles(ms):
    q = np.percentile(ms, [25, 50, 75])
    return {"p25_ms": float(q[0]), "p50_ms": float(q[1]), "p75_ms": float(q[2]), "max_ms": float(np.max(ms)),
            "spread": float((q[2] - q[0]) / q[1])}


def where(key):
    path, line, fn = key
    return f"{os.path.basename(path)}:{line}({fn})" if path != "~" else fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=60)
    args = ap.parse_args(argv)
    harness.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("noise: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(args.workload)
    if cell.mix["loop"] != "closed":
        print("noise: a closed-loop cell only", file=sys.stderr)
        return 2
    models = cell.module()
    model = models.Model(cell.cfg, args.seed, device)
    program = models.Program(model, device)
    loop = harness.ClosedLoop(cell, model, program, args.seed, device, print, 0.0)
    print(f"noise: {args.workload}, card {harness.card_line(device)}; set-up {time.perf_counter() - T_START!r} s")
    plain = []
    for i in range(args.calls):
        t = time.perf_counter()
        loop.program.predict(loop.blocks[i % len(loop.blocks)])
        plain.append((time.perf_counter() - t) * 1e3)
    gc_ms = [0.0]
    gc_start = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_start[0]) * 1e3

    gc.callbacks.append(on_gc)
    walls, own, gcs = [], [], []
    for i in range(args.calls):
        prof = cProfile.Profile()
        gc_ms[0] = 0.0
        t = time.perf_counter()
        prof.enable()
        loop.program.predict(loop.blocks[i % len(loop.blocks)])
        prof.disable()
        walls.append((time.perf_counter() - t) * 1e3)
        gcs.append(gc_ms[0])
        stats = pstats.Stats(prof).stats
        own.append({where(k): v[2] * 1e3 for k, v in stats.items()})
    gc.callbacks.remove(on_gc)
    order = np.argsort(walls)
    tenth = max(1, len(walls) // 10)
    fast, slow = order[:tenth], order[-tenth:]

    def mean_own(idx):
        acc = defaultdict(float)
        for i in idx:
            for k, v in own[i].items():
                acc[k] += v / len(idx)
        return acc

    f_own, s_own, all_own = mean_own(fast), mean_own(slow), mean_own(range(len(walls)))
    grew = sorted(set(f_own) | set(s_own), key=lambda k: -(s_own[k] - f_own[k]))[:TOP]
    out = {
        "card": harness.card_line(device),
        "unprofiled": quartiles(plain),
        "profiled": quartiles(walls),
        "fast_tenth_ms": float(np.mean([walls[i] for i in fast])),
        "slow_tenth_ms": float(np.mean([walls[i] for i in slow])),
        "gc_ms": {"fast": float(np.mean([gcs[i] for i in fast])), "slow": float(np.mean([gcs[i] for i in slow]))},
        "grew": [[k, s_own[k], f_own[k]] for k in grew],
        "most_own_time": [[k, v] for k, v in sorted(all_own.items(), key=lambda kv: -kv[1])[:TOP]],
        "walls_ms": [float(w) for w in walls],
    }
    for key in ("unprofiled", "profiled", "fast_tenth_ms", "slow_tenth_ms", "gc_ms"):
        print(f"{key}: {out[key]}")
    print("own ms a call, slowest tenth against fastest tenth:")
    for k, s, f in out["grew"]:
        print(f"  {s:9.3f} {f:9.3f}  {k}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
