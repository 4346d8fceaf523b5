"""Readings that set the limits of ``correct``: the control and the
faults of a cell, on several seeds in one process (the benchmark's own
runs never run this).

    python3 h100_bench/calibrate.py --workload <cell> --seeds 11,12,13

Serving cells: the reference put in the program's place, each stage one
precision below the configuration's (``stage_precision``: float32 →
TF32, bfloat16 → float8 e4m3), judged as the program's answers are, on
the cell's sample size, with the same inputs a run makes; and the
reference in its own precision in the program's place, which reads about
0. Training cells: the same control over the first three steps in float32
with TF32 products, and the faults of a step, planted in the reference in
float32 put in the program's place: "half_batch", "altered" and
"unchanged". Prints one JSON line a seed and kind.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import common, serving  # noqa: E402
from reference.precision import CONTROL_OF  # noqa: E402
from run import load_module, prepare_environment  # noqa: E402


def control_kinds(config: dict) -> dict:
    return {stage: CONTROL_OF[p]
            for stage, p in config["stage_precision"].items()}


def serving_readings(run: common.Run, fault_test: bool) -> list:
    sv = serving.inputs(run)
    rng = np.random.default_rng(common.sub_seed(run.seed, "calibrate"))
    n = run.traffic["check_sample"]
    share = run.traffic.get("catalog_share", 0.0)
    paths = [sv.db_paths[rng.integers(len(sv.db_paths))]
             if rng.random() < share
             else sv.pool[rng.integers(len(sv.pool))] for _ in range(n)]
    out = []
    kinds = {"control": control_kinds(run.config), "reference": {}}
    if fault_test:
        kinds["altered"] = {}
    for name, k in kinds.items():
        t = time.perf_counter()
        ans = serving.control_answers(run, sv, paths, k,
                                      fault="altered" if name == "altered"
                                      else None)
        nums = serving.judge(run, sv, ans)
        out.append({"kind": name, "kinds": k, **nums,
                    "seconds": time.perf_counter() - t})
    serving.cleanup(sv)
    return out


def train_readings(run: common.Run) -> list:
    train = load_module("drivers", "train")
    out = []
    for name, kw in (("control", {"kind": "tf32", "dtype": torch.float32}),
                     ("float32", {"dtype": torch.float32}),
                     ("half_batch", {"fault": "half_batch",
                                     "dtype": torch.float32}),
                     ("altered", {"fault": "altered",
                                  "dtype": torch.float32}),
                     ("unchanged", {"fault": "unchanged",
                                    "dtype": torch.float32})):
        got = train.follow(run, **kw)
        nums = train.judge(run, got["losses"], got["given1"], got["change"])
        out.append({"kind": name, **nums})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args()
    cell = {w["name"]: w for w in common.benchmark()["workloads"]}[
        args.workload]
    config = common.load_config(cell["config"])
    traffic = common.load_traffic(cell["traffic"])
    prepare_environment(config)
    card = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = common.Run(cell=cell, config=config, traffic=traffic,
                         seed=seed, seconds=0, trace=False,
                         device=args.device, t_start=time.perf_counter())
        rows = (train_readings(run) if traffic["driver"] == "train"
                else serving_readings(run, bool(args.faults)))
        for r in rows:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "card": card, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
