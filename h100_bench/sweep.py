"""Find the knee of an online cell: the highest offered rate at which the
backlog does not grow over the window.

    python3 h100_bench/sweep.py --workload w2v2-online --seed <n> \
        --seconds 8 --rates 100,150,200,250,300

One process sets the cell up once and offers each rate in turn for
``--seconds`` (a fresh schedule each). A rate holds when every request is
answered and the median latency of the window's last quarter of requests
is under twice that of its second quarter plus 50 ms (a queue that grows
all through the window fails it). Prints one JSON line a rate.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

from harness import common  # noqa: E402
from run import load_module, prepare_environment  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    cell = {w["name"]: w for w in common.benchmark()["workloads"]}[
        args.workload]
    config = common.load_config(cell["config"])
    traffic = common.load_traffic(cell["traffic"])
    prepare_environment(config)
    run = common.Run(cell=cell, config=config, traffic=traffic,
                     seed=args.seed, seconds=args.seconds, trace=False,
                     device="cuda", t_start=T_START)
    online = load_module("drivers", "online")
    on = online.start(run)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        w = online.window(run, on, rate, args.seconds, tag=f"sweep{i}")
        lat, n = w["lat"], w["n"]
        q2 = statistics.median(lat[n // 4:n // 2])
        q4 = statistics.median(lat[3 * n // 4:])
        answered = sum(r is not None for r in w["results"])
        holds = bool(answered == n and q4 < 2 * q2 + 50.0)
        print(json.dumps({
            "rate": rate, "n": n, "answered": answered,
            "p50_ms": common.nearest_rank(lat, 0.5),
            "p95_ms": common.nearest_rank(lat, 0.95),
            "q2_median_ms": q2, "q4_median_ms": q4,
            "calls": len(w["calls"]),
            "mean_batch": answered / max(1, len(w["calls"])),
            "holds": holds}), flush=True)
    on.batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
