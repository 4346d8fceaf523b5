"""Online scoring: open-loop arrivals through ``PredictBatcher``.

The traffic file gives the rate, the pool of fresh clips, the share of
catalog picks (DB clips, which exclude their own row) and the batcher's
settings. The schedule is N = rate x seconds requests whose gaps are one
fixed set of exponential gaps, scaled to the window, in an order drawn
from the seed (a Poisson process with its count and its gaps fixed, so
every seed offers the same work and the same bursts, in another order),
with exactly the catalog share of them catalog picks; each is sent at its
time from a pool of client threads, whether or not earlier ones have
finished, and timed from that time to its result. A request that fails or has no result
a minute after the window closes counts as missing (its latency is the
time it was waited for).
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from harness import program, serving
from harness.common import Run, nearest_rank, sub_seed
from harness.trace import Tracer
from flops import counts


@dataclass
class Online:
    sv: object
    inst: object
    batcher: object
    tracer: object
    clock: dict


def start(run: Run) -> Online:
    """Set-up: inputs, pipeline, batcher, and every batch size warmed."""
    tr = run.traffic
    sv = serving.setup(run)
    pipe = sv.pipe
    tracer = (Tracer(sv.scratch, "batcher: no request, or the linger")
              if run.trace else None)
    clock = {"slice0": float("inf"), "closing": False}

    def on_call():  # on the batcher's thread, before each predict_batch
        if tracer is None:
            return
        if tracer.prof is None and time.perf_counter() >= clock["slice0"]:
            tracer.start()
        elif tracer.running and clock["closing"]:
            tracer.stop()

    inst = program.Instrument(pipe, ranges=run.trace, on_call=on_call,
                              keep_every=tr["keep_every"],
                              keep_from=sub_seed(run.seed, "kept"))
    batcher = program.predict_batcher(pipe, tr["max_batch"], tr["linger_ms"])
    for b in tr["warm_batches"]:
        for _ in range(2):
            pipe.predict_batch(sv.pool[:b])
    for p in sv.pool[:4]:
        batcher.predict(p)
    program.warm_full_scan(pipe, tr["warm_batches"])
    if tracer is not None:
        tracer.warm(run.device)
    if run.device != "cpu":
        torch.cuda.synchronize()
    inst.reset()
    return Online(sv, inst, batcher, tracer, clock)


def window(run: Run, on: Online, rate: float, seconds: float,
           tag: str = "arrivals") -> dict:
    """Send the schedule at ``rate`` for ``seconds``; wait for every answer
    up to a minute past the close. → the window's record."""
    tr, sv = run.traffic, on.sv
    rng = np.random.default_rng(sub_seed(run.seed, tag))
    n = int(round(rate * seconds))
    # the same gaps for every seed; the last one, after the last request,
    # is left out of the order, so every schedule ends at the same time
    gaps = np.random.default_rng(sub_seed(0, tag)).exponential(size=n + 1)
    gaps *= seconds / gaps.sum()
    due = np.cumsum(rng.permutation(gaps[:n]))
    catalog = rng.permutation(n) < int(round(tr["catalog_share"] * n))
    paths = [sv.db_paths[rng.integers(len(sv.db_paths))] if c
             else sv.pool[rng.integers(len(sv.pool))] for c in catalog]
    results, done = [None] * n, [None] * n
    lock = threading.Lock()
    errors = []

    def send(i):
        try:
            r = on.batcher.predict(paths[i])
            t = time.perf_counter()
            with lock:
                results[i], done[i] = r, t
        except Exception as e:  # a failed request is missing
            errors.append(repr(e))

    pool = cf.ThreadPoolExecutor(tr["clients"])
    on.inst.reset()
    late, futs = [], []
    t0 = time.perf_counter()
    on.clock["slice0"] = t0 + seconds - min(tr["trace_seconds"], seconds / 2)
    for i in range(n):
        wait = t0 + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append((time.perf_counter() - t0 - due[i]) * 1e3)
        futs.append(pool.submit(send, i))
    cf.wait(futs, timeout=max(0.0, t0 + seconds + 60.0
                              - time.perf_counter()))
    t_wait = time.perf_counter()
    pool.shutdown(wait=False)
    lat = [((done[i] if done[i] is not None else t_wait) - t0 - due[i]) * 1e3
           for i in range(n)]
    return {"t0": t0, "n": n, "due": due, "paths": paths, "results": results,
            "lat": lat, "late": late, "errors": errors,
            "calls": list(on.inst.calls)}


def run(run: Run) -> None:
    tr, cfg = run.traffic, run.config
    on = start(run)
    pipe = on.sv.pipe
    run.e2e["setup_s"] = time.perf_counter() - run.t_start
    w = window(run, on, tr["rate_per_s"], run.seconds)
    run.counters["searches"] = pipe.index.searches
    run.counters["fallbacks"] = pipe.index.fallbacks
    on.clock["closing"] = True
    if on.tracer is not None and on.tracer.running:
        on.batcher.predict(on.sv.pool[0])  # the call that stops the profiler
        run.trace_summary = on.tracer.summary
        run.note(on.tracer.describe())

    n, results, calls = w["n"], w["results"], w["calls"]
    answered = [i for i in range(n) if results[i] is not None]
    run.attempted, run.failed = n, n - len(answered)
    run.e2e["latency_p50_ms"] = nearest_rank(w["lat"], 0.50)
    run.e2e["latency_p95_ms"] = nearest_rank(w["lat"], 0.95)
    run.spans["queue_ms"] = [results[i]["stage_ms"]["queue"]
                             for i in answered]
    run.spans["decode_ms"] = [c["out"][0]["stage_ms"]["decode"]
                              for c in calls]
    run.spans["call_s"] = [c["t1"] - c["t0"] for c in calls]
    run.spans["late_ms"] = w["late"]
    run.counters["answered"] = len(answered)
    run.counters["calls"] = len(calls)
    run.counters["model_flops"] = len(answered) * counts.clip_flops(cfg)
    run.note(f"online: {n} requests at {tr['rate_per_s']}/s, {len(calls)} "
             f"calls, generator late p99 "
             f"{nearest_rank(w['late'], 0.99):.3f} ms, certified searches "
             f"{run.counters['searches']}, fallbacks "
             f"{run.counters['fallbacks']}, "
             f"errors {w['errors'][:3]}")

    # the sample to judge, drawn from the seed among the answered requests
    # of the calls whose embeddings were kept
    kept = [i for i in answered
            if calls[on.inst.of_result[id(results[i])][0]]["tpp"] is not None]
    pick = np.random.default_rng(sub_seed(run.seed, "check")).choice(
        len(kept), min(tr["check_sample"], len(kept)), replace=False)
    sample = []
    for j in sorted(pick):
        r = results[kept[j]]
        call, row = on.inst.of_result[id(r)]
        sample.append((w["paths"][kept[j]],
                       calls[call]["tpp"][row].detach().clone(), r))
    on.batcher.close()
    sv = on.sv
    del on, w, calls, results, pipe
    serving.free(sv, run)
    limits = cfg["limits"]["serving"]
    for name, val in serving.judge(run, sv, sample).items():
        if name in limits:
            run.checks.append((name, val, limits[name]))
        else:
            run.note(f"reading {name} {val!r} (not compared)")
    serving.cleanup(sv)
