"""One run of one benchmark cell of radad_tpu_torch on NVIDIA GPUs.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``h100_bench/configs/<config>.json``) and a traffic mix
(``h100_bench/traffic/<traffic>.json``), whose ``driver`` names the code
that sets it up, runs the window and checks it (``drivers/<driver>.py``).
The configuration's ``"encoder"`` names its encoder's weights, plain
forward and operations (``encoders/<encoder>.py``), whose ``PORT`` names
the port's module and classes that build it.
With ``--trace 0`` the cell's end-to-end metrics are reported; with
``--trace 1`` its per-layer metrics, each read by ``metrics/<name>.py``.
The last line of standard output is the result, as JSON; the numbers
compared to decide ``correct`` come last on standard error and under
``checks`` in the result. No result is printed, and the exit code is not 0,
where the encoder file, or the port's module or classes that its ``PORT``
names, are missing, where CUDA is missing or has fewer devices than the
cell asks for, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# the harness's modules, then the program under test at the checkout's root
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

from harness import common  # noqa: E402
from harness.common import load_module  # noqa: E402


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def prepare_environment(config: dict) -> None:
    """The configuration's switches; every cache the program's libraries
    could write kept at fixed paths inside the checkout; one thread for
    the host's math libraries (the runs measure one process whose host
    work is a single thread of dispatch, and idle pool threads only add
    noise)."""
    for key, val in config.get("environment", {}).items():
        os.environ[key] = str(val)
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[key] = "1"
    for key, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[key] = os.path.join(common.CACHE_DIR, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def execute(bench: dict, cell: dict, run: common.Run) -> dict:
    """Run the cell's driver and read its metrics. → the result."""
    load_module("drivers", run.traffic["driver"]).run(run)
    metrics = {}
    if run.trace:
        for m in bench["per_layer"]:
            if applies(m, cell["name"]):
                value = load_module("metrics", m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, cell["name"]) and m["name"] in run.e2e:
                metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                      "unit": m["unit"]}
    return metrics


def device_info(run: common.Run) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.chips, "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace and run.trace_summary is not None:
        info["busy_s"] = run.trace_summary.busy_s
        info["window_s"] = run.trace_summary.window_s
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = common.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    config = common.load_config(cell["config"])
    traffic = common.load_traffic(cell["traffic"])
    prepare_environment(config)
    # a configuration the harness cannot build fails before any CUDA work
    from harness import program

    try:
        program.port_encoder(config)
    except (FileNotFoundError, ValueError) as e:
        print(e, file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"need {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run = common.Run(cell=cell, config=config, traffic=traffic,
                     seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device="cuda",
                     t_start=T_START, chips=cell["chips"])
    metrics = execute(bench, cell, run)
    found = common.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info(run)}
    s = run.trace_summary
    if run.trace and s is not None:
        result["breakdown"] = {"device_ops": s.top_ops(10),
                               "idle_gaps": s.idle_gaps(10)}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in run.checks}
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
