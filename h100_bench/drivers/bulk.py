"""Bulk scoring: ``DetectionPipeline.predict_batch`` back to back from one
caller (a closed loop).

Each call draws ``batch`` distinct clips from a seeded pool of fresh
clips. The window runs until the first call that ends at or after
``seconds``; the rate is the clips of every call in it over its whole
length.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import program, serving
from harness.common import Run, sub_seed
from harness.trace import Tracer
from flops import counts


def run(run: Run) -> None:
    tr, cfg = run.traffic, run.config
    sv = serving.setup(run)
    pipe = sv.pipe
    tracer = (Tracer(sv.scratch, "between calls") if run.trace
              else None)
    inst = program.Instrument(pipe, ranges=run.trace,
                              keep_every=tr["keep_every"],
                              keep_from=sub_seed(run.seed, "kept"))
    b = tr["batch"]
    rng = np.random.default_rng(sub_seed(run.seed, "draws"))

    def draw():
        return [sv.pool[i] for i in rng.choice(len(sv.pool), b,
                                               replace=False)]

    for _ in range(tr["warm_calls"]):
        pipe.predict_batch(draw())
    program.warm_full_scan(pipe, [b])
    if tracer is not None:
        tracer.warm(run.device)
    if run.device != "cpu":
        torch.cuda.synchronize()
    inst.reset()

    t0 = time.perf_counter()
    run.e2e["setup_s"] = t0 - run.t_start
    slice0 = t0 + run.seconds - min(tr["trace_seconds"], run.seconds / 2)
    while time.perf_counter() - t0 < run.seconds:
        if tracer is not None and tracer.prof is None \
                and time.perf_counter() >= slice0:
            tracer.start()
        pipe.predict_batch(draw())
    t_end = time.perf_counter()
    if tracer is not None and tracer.running:
        tracer.stop()
        run.trace_summary = tracer.summary
        run.note(tracer.describe())

    calls = list(inst.calls)
    clips = sum(c["batch"] for c in calls)
    run.attempted, run.failed = clips, 0
    run.e2e["clips_per_s"] = clips / (t_end - t0)
    run.spans["decode_ms"] = [c["out"][0]["stage_ms"]["decode"]
                              for c in calls]
    run.spans["call_s"] = [c["t1"] - c["t0"] for c in calls]
    run.counters["answered"] = clips
    run.counters["calls"] = len(calls)
    run.counters["model_flops"] = clips * counts.clip_flops(cfg)
    run.counters["searches"] = pipe.index.searches
    run.counters["fallbacks"] = pipe.index.fallbacks
    run.note(f"bulk: {len(calls)} calls of {b} in {t_end - t0:.3f} s, "
             f"certified searches {pipe.index.searches}, fallbacks "
             f"{pipe.index.fallbacks}")

    # the sample to judge, drawn from the seed among the clips of the calls
    # whose embeddings were kept
    kept = [c for c in calls if c["tpp"] is not None]
    pick = np.random.default_rng(sub_seed(run.seed, "check")).choice(
        len(kept) * b, min(tr["check_sample"], len(kept) * b), replace=False)
    sample = []
    for j in sorted(pick):
        c = kept[j // b]
        sample.append((c["paths"][j % b], c["tpp"][j % b].detach().clone(),
                       c["out"][j % b]))
    del inst, calls
    serving.free(sv, run)
    del pipe
    limits = cfg["limits"]["serving"]
    for name, val in serving.judge(run, sv, sample).items():
        if name in limits:
            run.checks.append((name, val, limits[name]))
        else:
            run.note(f"reading {name} {val!r} (not compared)")
    serving.cleanup(sv)
