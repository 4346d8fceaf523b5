"""Tiny configurations and a CPU run of a driver, for the harness's tests.

The widths are cut far below the published ones, as each encoder file's
``TINY`` says: these runs check the harness's control flow and its
comparison on the CPU, never a speed."""

from __future__ import annotations

import copy
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.dirname(BENCH_DIR), BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import common  # noqa: E402


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(common.load_config(name))
    for part, cut in common.encoder(cfg).TINY.items():
        cfg[part].update(cut)
    cfg["pipeline"].update(projection_hidden_dim=16, projection_output_dim=8,
                           batch_size=16)
    cfg.update(db_clips=8, index_rows=300)
    return cfg


def tiny_traffic(name: str) -> dict:
    tr = copy.deepcopy(common.load_traffic(name))
    tr.update(pool=16, check_sample=8, trace_seconds=0.5, keep_every=2)
    if tr["driver"] == "online":
        tr.update(rate_per_s=20.0, warm_batches=[1, 2, 4], clients=8,
                  max_batch=4)
    if tr["driver"] == "bulk":
        tr.update(batch=4, warm_calls=1)
    return tr


def load_driver(name: str):
    import run

    return run.load_module("drivers", name)


def cpu_run(config: str, traffic: str, *, seed: int = 2**31 + 7,
            seconds: float = 1.0, trace: bool = False,
            cfg=None, traffic_update: dict = None) -> common.Run:
    cfg = cfg or tiny_config(config)
    tr = tiny_traffic(traffic)
    tr.update(traffic_update or {})
    run = common.Run(cell={"name": f"tiny-{traffic}"}, config=cfg,
                     traffic=tr, seed=seed, seconds=seconds, trace=trace,
                     device="cpu", t_start=time.perf_counter())
    load_driver(tr["driver"]).run(run)
    return run
