#!/usr/bin/env python3
"""The benchmark's reference put in the program's place in a serving cell
with rounding or mechanism switches of one's own (``kinds``), judged as the
program's answers are: the readings ``h100_bench/calibrate.py`` takes for
its control, for another control. With ``{"rel_bias": "off"}`` the WavLM
reference drops the gated relative position bias from its logits, which
``embed_err`` has to see.

    python3 experiments/bench_kinds_control.py --workload wavlm-large-bulk \
        --seeds 11,12 --kinds '{"rel_bias": "off"}'

Prints one JSON line a seed. Runs on the card (``--device cuda``, the
default) or, at the published widths and slowly, on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(REPO, "h100_bench")
sys.path[:0] = [BENCH_DIR, REPO]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import common, serving  # noqa: E402
from run import prepare_environment  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", required=True, help="JSON object")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    kinds = json.loads(args.kinds)
    cell = {w["name"]: w for w in common.benchmark()["workloads"]}[
        args.workload]
    config = common.load_config(cell["config"])
    traffic = common.load_traffic(cell["traffic"])
    prepare_environment(config)
    if args.device == "cuda":
        from radad_tpu_torch.utils.device import resolve_device

        resolve_device("cuda")  # the precision flags the program runs with
    card = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = common.Run(cell=cell, config=config, traffic=traffic,
                         seed=seed, seconds=0, trace=False,
                         device=args.device, t_start=time.perf_counter())
        t = time.perf_counter()
        sv = serving.inputs(run)
        # the sample calibrate.py draws for the same seed
        rng = np.random.default_rng(common.sub_seed(seed, "calibrate"))
        share = traffic.get("catalog_share", 0.0)
        paths = [sv.db_paths[rng.integers(len(sv.db_paths))]
                 if rng.random() < share
                 else sv.pool[rng.integers(len(sv.pool))]
                 for _ in range(traffic["check_sample"])]
        nums = serving.judge(run, sv, serving.control_answers(
            run, sv, paths, kinds))
        serving.cleanup(sv)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "card": card, "kinds": kinds, **nums,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
