#!/usr/bin/env python3
"""The device's idle time in a benchmark cell, put down to the program's
own spans, and what a span costs.

``--cell <name>`` runs one cell of ``BENCHMARK.json`` through the
benchmark's harness (``h100_bench/``) with its trace on, as
``h100_bench/run.py --trace 1`` does, and prints:

* the idle share of the traced slice split by the host stage open over it
  (``radad.batcher.wait``, ``radad.batcher.linger``, ``radad.decode``,
  ``radad.device``, ``radad.payload``), the same idle time by the
  innermost range open over it, and the remainder: the idle time in gaps
  under none of the host stages, by innermost range, and the idle time
  before the slice's first and after its last device op;
* each collection of the interpreter's garbage collector as a range
  ``gc:gen<N>``, so that the idle time it holds is named;
* the device ms per call under the program's ``radad.embed``,
  ``radad.search`` and ``radad.model`` spans beside the harness's own
  ``embed:``, ``search`` and ``model`` ranges around the same calls;
* the batch decode's counters (``data.audio.decode_counts``) over the
  whole run, warm-up included, where the program has them;
* with ``--decode-times``, each batch decode's wall time on the host's
  clock and, for its slowest calls, when each thread of the pool finished
  its rows and the longest row, so that a slow call shows whether one
  thread or every thread was late (no spans: ``data.audio._decode_row`` and
  ``load_audio_batch`` are wrapped in this process only).

``--cost`` times ``utils.profiling.annotate`` per span entered and left,
with no profiler on the thread and with ``torch.profiler`` (CPU and CUDA)
running, beside a bare ``record_function``.

Run from the root of a checkout on a machine with a GPU:
``python3 experiments/serving_spans.py --cell w2v2-online --seed 7
--seconds 51`` or ``python3 experiments/serving_spans.py --cost``.
"""

from __future__ import annotations

import bisect
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "h100_bench")

HOST_STAGES = ("radad.batcher.wait", "radad.batcher.linger", "radad.decode",
               "radad.device", "radad.payload")


def cost(n_off: int = 200_000, n_on: int = 20_000) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, ROOT)
    from radad_tpu_torch.utils.profiling import annotate

    def per_span(body, n):
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        return (time.perf_counter() - t0) / n * 1e6

    def empty():
        pass

    def span():
        with annotate("radad.x"):
            pass

    def bare():
        with record_function("radad.x"):
            pass

    for _ in range(3):
        loop = per_span(empty, n_off)
        off = per_span(span, n_off) - loop
        bare_off = per_span(bare, n_on) - loop
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            on = per_span(span, n_on) - loop
        print(f"span cost (us per span): profiler off {off:.4f}, on "
              f"{on:.3f}; record_function with no profiler {bare_off:.3f}",
              flush=True)


def _label(name: str) -> str:
    return name.split(":")[0]


def gc_ranges() -> None:
    """Record each collection of the interpreter's cyclic garbage collector
    as a ``gc:gen<N>`` range, on a thread whose profiler runs."""
    import gc
    import threading

    import torch
    from torch.profiler import record_function

    open_ = {}

    def callback(phase, info):
        key = threading.get_ident()
        if phase == "start" and torch._C._autograd._profiler_enabled():
            open_[key] = record_function(f"gc:gen{info['generation']}")
            open_[key].__enter__()
        elif phase == "stop" and key in open_:
            open_.pop(key).__exit__(None, None, None)

    gc.callbacks.append(callback)


def decode_times():
    """Wrap the batch decode and its per-row decode with host clock reads.
    → a function that prints what they recorded; None where the program
    has no batch decode."""
    import statistics
    import threading

    from radad_tpu_torch.data import audio
    from radad_tpu_torch.train import pipeline

    if not hasattr(audio, "_decode_row"):
        return None
    calls, rows_ = [], []
    row, batch = audio._decode_row, audio.load_audio_batch

    def timed_row(*a, **k):
        t0 = time.perf_counter()
        try:
            return row(*a, **k)
        finally:
            rows_.append((threading.get_ident(), t0, time.perf_counter()))

    def timed_batch(paths, *a, **k):
        t0 = time.perf_counter()
        try:
            return batch(paths, *a, **k)
        finally:
            calls.append((t0, time.perf_counter(), len(paths)))

    audio._decode_row = timed_row
    audio.load_audio_batch = pipeline.load_audio_batch = timed_batch

    def show(slowest: int = 8) -> None:
        pooled = sorted(c for c in calls if c[2] > 1)
        if not pooled:
            return
        ms = [(t1 - t0) * 1e3 for t0, t1, _ in pooled]
        q1, med, q3 = statistics.quantiles(ms, n=4)
        print(f"decode calls of 2 rows or more: {len(ms)}, ms median "
              f"{med:.3f} q1 {q1:.3f} q3 {q3:.3f} max {max(ms):.3f}; "
              f"over 3x the median {sum(m > 3 * med for m in ms)}")
        starts = [t0 for t0, _, _ in pooled]
        by_call = [[] for _ in pooled]
        for tid, t0, t1 in rows_:
            i = bisect.bisect_right(starts, t0) - 1
            if i >= 0 and t1 <= pooled[i][1]:
                by_call[i].append((tid, t0, t1))
        for i in sorted(range(len(pooled)), key=lambda i: -ms[i])[:slowest]:
            c0 = pooled[i][0]
            done = {}
            for tid, t0, t1 in by_call[i]:
                done[tid] = max(done.get(tid, 0.0), t1 - c0)
            ends = sorted(1e3 * v for v in done.values())
            longest = max(((t1 - t0) * 1e3 for _, t0, t1 in by_call[i]),
                          default=0.0)
            first = min(((t0 - c0) * 1e3 for _, t0, _ in by_call[i]),
                        default=0.0)
            print(f"  call at {c0:.3f} s: {ms[i]:.3f} ms, {pooled[i][2]} "
                  f"rows, {len(done)} threads finished at ms "
                  f"{[round(e, 2) for e in ends]}, longest row "
                  f"{longest:.3f} ms, first row began {first:.3f} ms in")
    return show


def cell(name: str, seed: int, seconds: float,
         times: bool = False) -> None:
    sys.path[:0] = [BENCH, ROOT]
    gc_ranges()
    show = decode_times() if times else None
    import run as runner
    from harness import common

    bench = common.benchmark()
    c = {w["name"]: w for w in bench["workloads"]}[name]
    config = common.load_config(c["config"])
    runner.prepare_environment(config)
    r = common.Run(cell=c, config=config,
                   traffic=common.load_traffic(c["traffic"]), seed=seed,
                   seconds=seconds, trace=True, device="cuda",
                   t_start=time.perf_counter(), chips=c["chips"])
    metrics = runner.execute(bench, c, r)
    print(f"cell {name} seed {seed}: correct {r.correct}")
    report(r, metrics)
    # the batch decode's counters, where the program has them
    from radad_tpu_torch.data import audio
    counts = getattr(audio, "decode_counts", None)
    if counts is not None:
        print(f"decode counts: {vars(counts)}")
    if show is not None:
        show()


def report(r, metrics: dict) -> None:
    from harness import readers, spans

    s = r.trace_summary
    print(f"window {s.window_s:.4f} s, busy {s.busy_s:.4f} s")
    print("metrics " + ", ".join(f"{k} {v['value']:.6g}"
                                 for k, v in metrics.items()))
    idle = readers.idle_share(r)
    parts = {st: spans.idle_share_under(r, st) for st in HOST_STAGES}
    print(f"idle {idle:.4f} % = " + " + ".join(
        f"{st} {v:.4f}" for st, v in parts.items())
        + f" + remainder {idle - sum(parts.values()):.4f}")

    # every idle gap cut at the host stages' edges, each piece put down to
    # the innermost range open over its middle; the remainder is the
    # pieces under no host stage
    stages = spans._union((ts, ts + d) for n, ts, d in s.ranges
                          if n in HOST_STAGES)
    ends = [hi for _, hi in stages]
    by: dict = {}
    for ts, dur in s.gaps:
        cuts = [ts, ts + dur]
        for lo, hi in stages[bisect.bisect_right(ends, ts):]:
            if lo >= ts + dur:
                break
            cuts += [x for x in (lo, hi) if ts < x < ts + dur]
        cuts.sort()
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            open_ = [x for x in s.ranges if x[1] <= mid <= x[1] + x[2]]
            lab = (_label(min(open_, key=lambda x: x[2])[0]) if open_
                   else s.idle_label)
            under = any(x[0] in HOST_STAGES for x in open_)
            tot, n, big = by.get((under, lab), (0.0, 0, 0.0))
            by[(under, lab)] = (tot + b - a, n + 1, max(big, b - a))
    gaps = sum(d for _, d in s.gaps) * 1e-6
    edges = s.window_s - s.busy_s - gaps

    def line(under):
        return ", ".join(
            f"{lab} {100 * t * 1e-6 / s.window_s:.4f} ({n} gaps, longest "
            f"{big * 1e-3:.3f} ms)"
            for (u, lab), (t, n, big) in sorted(by.items(),
                                                 key=lambda kv: -kv[1][0])
            if u == under)
    print(f"idle by innermost range (%): {line(True)}")
    print(f"remainder by innermost range (%): {line(False)}; before the "
          f"first and after the last device op "
          f"{100 * edges / s.window_s:.4f}")
    print(f"ten longest gaps: {s.idle_gaps(10)}")
    for ours, theirs in (("radad.embed", "embed:"), ("radad.search", "search"),
                         ("radad.model", "model")):
        a = readers.device_ms_per_range(r, ours)
        b = readers.device_ms_per_range(r, theirs)
        print(f"device ms per call: {ours} {a!r} ({len(s.ranges_named(ours))}"
              f" spans), {theirs} {b!r} ({len(s.ranges_named(theirs))} "
              f"ranges)")
    sys.stdout.flush()


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--decode-times", action="store_true")
    args = ap.parse_args()
    if args.cost:
        cost()
    if args.cell:
        cell(args.cell, args.seed, args.seconds, args.decode_times)
    return 0


if __name__ == "__main__":
    sys.exit(main())
