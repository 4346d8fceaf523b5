#!/usr/bin/env python3
"""Where a ``predict_batch`` call's host decode spends its time, stage by
stage, and how the decode scales on a pool of threads.

Writes the benchmark's own clips (``h100_bench/harness/clips.py``: 3 s of
16-bit mono at 16 kHz, so nothing is resampled) into a temporary
directory, then times calls of ``--batch`` distinct clips, each stage on
its own over the same draws:

* ``read``: the file's bytes read from Python (``open().read()``);
* ``c_call``: the native decoder's C call alone, into one kept buffer;
* ``native.decode``: the C call with its wrapper's two fresh buffers;
* ``load_audio``: ``radad_tpu_torch.data.audio.load_audio`` a clip;
* ``np.stack``: the call's clips stacked into one batch array;
* ``serial``: ``load_audio`` a clip and ``np.stack``, as ``predict_batch``
  decoded before it took ``load_audio_batch``;
* ``upload pageable`` / ``upload pinned``: the batch to the card from a
  fresh array and from a page-locked tensor, synchronized;
* ``pool <n>``: the C call a clip on ``n`` threads, each row written into
  one kept page-locked batch, a task a clip; ``pool <n> chunked``: the
  same with one task of contiguous rows a thread; ``pool <n> + upload
  pinned``: the first followed by the batch's upload;
* ``pool <n> load_audio + copy``: ``load_audio(pad=False)`` a clip on
  ``n`` threads and the samples copied into the clip's row, zeros past
  them, with one task of contiguous rows a thread (``chunked``), a task a
  clip (``a task a clip``) or one task a thread that takes the next row
  not yet taken until none is left (``next row``);
* ``batch kept`` / ``batch fresh``: ``load_audio_batch`` into one kept
  batch, or into a new ``torch.empty(..., pin_memory=True)`` a call (the
  caching host allocator's block once the last upload from it is done),
  each followed by the upload; and ``load_audio_batch`` alone.

Each stage prints its median and quartiles in ms a call and the minor
page faults a call (``getrusage``). Run from the root of a checkout:
``python3 experiments/decode_stages.py --out decode_stages.txt``
(on a machine without CUDA the upload stages are left out).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "h100_bench"))


def _faults() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


def _stage(name, calls, body, lines):
    """Time ``body(paths)`` over every call; one line of ms a call."""
    body(calls[0])  # warm
    ms, faults = [], []
    for paths in calls:
        f0, t0 = _faults(), time.perf_counter()
        body(paths)
        ms.append((time.perf_counter() - t0) * 1e3)
        faults.append(_faults() - f0)
    q1, med, q3 = statistics.quantiles(ms, n=4)
    line = (f"{name:<40} median {med:8.3f} ms  q1 {q1:8.3f}  q3 {q3:8.3f}  "
            f"min {min(ms):8.3f}  minor faults a call "
            f"{statistics.median(faults):.0f}")
    print(line, flush=True)
    lines.append(line)
    return med


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--pool", type=int, default=512)
    ap.add_argument("--seed", type=int, default=3220023001)
    ap.add_argument("--threads", default="4,7,8,16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from harness import clips
    from radad_tpu_torch.data.audio import load_audio, load_audio_batch
    from radad_tpu_torch.native import load

    lines = []

    def say(s):
        print(s, flush=True)
        lines.append(s)

    cuda = torch.cuda.is_available()
    if cuda and shutil.which("nvidia-smi"):
        say("card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    say(f"host: sched_getaffinity {len(os.sched_getaffinity(0))}, "
        f"cpu_count {os.cpu_count()}, torch {torch.__version__}")
    if cuda:
        torch.zeros(1, device="cuda")
    tmp = tempfile.mkdtemp(prefix="decode_stages_")
    try:
        rng = np.random.default_rng(args.seed)
        pool, _ = clips.write(tmp, "pool", args.pool, rng)
        say(f"clips: {args.pool} in {tmp}, {os.path.getsize(pool[0])} bytes "
            f"each; calls of {args.batch}, {args.calls} calls a stage")
        calls = [[pool[i] for i in rng.choice(len(pool), args.batch,
                                                replace=False)]
                 for _ in range(args.calls)]
        native = load()
        lib = native._lib
        width = 48_000
        cap = os.path.getsize(pool[0]) // 2 + 64
        kept = np.empty(cap, np.float32)
        kept_ptr = kept.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

        def read(paths):
            for p in paths:
                with open(p, "rb") as f:
                    f.read()

        def c_call(paths):
            sr = ctypes.c_int(0)
            for p in paths:
                lib.radad_decode_full(p.encode(), kept_ptr, cap,
                                      ctypes.byref(sr))

        def native_decode(paths):
            for p in paths:
                native.decode(p)

        def loads(paths):
            return [load_audio(p) for p in paths]

        arrays = loads(calls[0])

        def stack(_paths):
            np.stack(arrays)

        def serial(paths):
            return np.stack(loads(paths))

        _stage("read", calls, read, lines)
        _stage("c_call", calls, c_call, lines)
        _stage("native.decode", calls, native_decode, lines)
        _stage("load_audio", calls, loads, lines)
        _stage("np.stack", calls, stack, lines)
        _stage("serial (load_audio + stack)", calls, serial, lines)
        if cuda:
            fresh = np.stack(arrays)

            def up_pageable(_paths):
                torch.as_tensor(fresh, device="cuda")
                torch.cuda.synchronize()

            def up_fresh(paths):
                torch.as_tensor(serial(paths), device="cuda")
                torch.cuda.synchronize()

            pinned = torch.empty((args.batch, width), pin_memory=True)

            def up_pinned(_paths):
                pinned.to("cuda", non_blocking=True)
                torch.cuda.synchronize()

            _stage("upload pageable", calls, up_pageable, lines)
            _stage("serial + upload pageable", calls, up_fresh, lines)
            _stage("upload pinned", calls, up_pinned, lines)
        batch = torch.empty((args.batch, width), pin_memory=cuda)
        rows = batch.numpy()
        stride = rows.strides[0]
        base = rows.ctypes.data

        def row_call(arg):
            r, p = arg
            sr = ctypes.c_int(0)
            n = lib.radad_decode_full(
                p.encode(), ctypes.cast(base + r * stride,
                                        ctypes.POINTER(ctypes.c_float)),
                width, ctypes.byref(sr))
            if n < width:
                rows[r, max(n, 0):] = 0.0

        def copy_row(r, p):
            w = load_audio(p, pad=False)
            rows[r, :len(w)] = w
            rows[r, len(w):] = 0.0

        for n in [int(t) for t in args.threads.split(",")]:
            ex = ThreadPoolExecutor(n)

            def pooled(paths, ex=ex):
                list(ex.map(row_call, enumerate(paths)))

            def chunks(paths, body, ex=ex, n=n):
                jobs = list(enumerate(paths))
                step = -(-len(jobs) // n)
                list(ex.map(lambda lo: [body(j) for j in
                                        jobs[lo:lo + step]],
                            range(0, len(jobs), step)))

            def chunked(paths):
                chunks(paths, row_call)

            def copy_chunked(paths):
                chunks(paths, lambda j: copy_row(*j))

            def copy_each(paths, ex=ex):
                list(ex.map(copy_row, range(len(paths)), paths))

            def copy_next(paths, ex=ex, n=n):
                taken = iter(range(len(paths)))

                def worker():
                    for r in taken:
                        copy_row(r, paths[r])
                list(f.result() for f in [ex.submit(worker)
                                          for _ in range(n)])

            _stage(f"pool {n} (C call into rows)", calls, pooled, lines)
            _stage(f"pool {n} chunked", calls, chunked, lines)
            _stage(f"pool {n} load_audio + copy chunked", calls,
                   copy_chunked, lines)
            _stage(f"pool {n} load_audio + copy a task a clip", calls,
                   copy_each, lines)
            _stage(f"pool {n} load_audio + copy next row", calls,
                   copy_next, lines)
            if cuda:
                def pooled_up(paths, pooled=pooled):
                    pooled(paths)
                    batch.to("cuda", non_blocking=True)
                    torch.cuda.synchronize()
                _stage(f"pool {n} + upload pinned", calls, pooled_up, lines)
            ex.shutdown()

        def entry(paths):
            load_audio_batch(paths, rows)

        def kept(paths):
            load_audio_batch(paths, batch)
            batch.to(batch_dev, non_blocking=True)
            if cuda:
                torch.cuda.synchronize()

        def fresh(paths):
            b = torch.empty((len(paths), width), pin_memory=cuda)
            load_audio_batch(paths, b)
            b.to(batch_dev, non_blocking=True)
            if cuda:
                torch.cuda.synchronize()

        batch_dev = "cuda" if cuda else "cpu"
        _stage("load_audio_batch", calls, entry, lines)
        _stage("batch kept + upload", calls, kept, lines)
        _stage("batch fresh + upload", calls, fresh, lines)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
