"""Training: the body of ``DetectionPipeline.train``'s loop, on cached
embeddings.

The rows (``rows.train_rows``) are installed as the pipeline's embedding
cache for a manifest of their names, and ``build_vector_database`` makes
them the index too, so the encoder never runs. Set-up builds the steps and
runs the first three of epoch 1 (``StepFns.train_step`` over
``_query_batches(shuffle=True)``, the pipeline's own generator for the
dropout masks): those are the steps the reference follows, and they warm
every shape. The window goes on with the same steps, reading the epoch's
accumulators once at each epoch's end, until ``seconds`` have passed; the
rate is the steps over the window's length, ended by a synchronize.

With ``--trace 1`` the last ``trace_seconds`` of the window run each
step as ``fetch``, ``forward_backward`` and ``apply`` (the same math as
``train_step``), each ended by a synchronize and timed on the host, under
the profiler.
"""

from __future__ import annotations

import gc
import os
import shutil
import time

import numpy as np
import torch

from harness import check, program, rows as R, weights as W
from harness.common import Run, file_id, scratch_dir
from harness.trace import Tracer
from flops import counts
from reference import train as RT


def _names(n):
    return [f"train_{i:06d}.wav" for i in range(n)]


def _rows(run: Run):
    cfg = run.config
    share = cfg["spoof_clips"] / cfg["total_clips"]
    return R.train_rows(cfg["index_rows"], W.tpp_dim(cfg), share, run.seed,
                        run.device)


def _sync(run):
    if run.device != "cpu":
        torch.cuda.synchronize()


def run(run: Run) -> None:
    cfg, tr, dev = run.config, run.traffic, run.device
    scratch = scratch_dir(run.cell["name"])
    rows, labels = _rows(run)
    enc_w = W.encoder_weights(cfg, run.seed, dev)
    fus_w = W.fusion_weights(cfg, run.seed, dev)
    _sync(run)
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    pipe = program.build_pipeline(cfg, enc_w, fus_w, dev,
                                  os.path.join(scratch, "root"), run.seed)
    del enc_w, fus_w
    manifest = program.train_manifest(_names(rows.shape[0]),
                                      labels.cpu().numpy())
    program.install_embeddings(pipe, manifest, rows)
    pipe.build_vector_database(manifest, save=False)
    del rows, labels
    steps = pipe._steps()
    b = pipe.config.batch_size
    pos_weight = manifest.pos_weight()
    params = dict(pipe.model.named_parameters())
    theta0 = {n: p.detach().clone() for n, p in params.items()}

    def batches():
        epoch = 0
        while True:
            acc = program.new_accumulators(pipe.device)
            for batch in pipe._query_batches(
                    manifest, b, shuffle=True,
                    seed=pipe.config.random_seed + epoch):
                yield acc, batch
            # one device-to-host read of the epoch's sums
            torch.stack([acc[k] for k in program.acc_keys()]).tolist()
            epoch += 1

    feed = batches()
    losses, given1 = [], None
    for step in range(3):
        acc, (tpp, lab, ids, valid) = next(feed)
        bm = steps.train_step(acc, tpp, lab, ids, valid, pos_weight,
                              pipe.generator)
        losses.append(bm["loss"])
        if step == 0:
            given1 = {n: t / (1 - pipe.opt.b1)
                      for g in pipe.opt.state.values()
                      for n, t in g["mu"].items()}
    theta3 = {n: p.detach().clone() for n, p in params.items()}
    program.warm_full_scan(pipe, [b])
    _sync(run)

    tracer = Tracer(scratch, "between steps") if run.trace else None
    if tracer is not None:
        tracer.warm(dev)
    t0 = time.perf_counter()
    run.e2e["setup_s"] = t0 - run.t_start
    slice0 = t0 + run.seconds - (min(tr["trace_seconds"], run.seconds / 2)
                                 if tracer is not None else 0.0)
    n, t_plain, n_plain = 0, None, 0
    stage = {"retrieve_ms": [], "forward_backward_ms": [], "update_ms": []}
    while time.perf_counter() - t0 < run.seconds:
        acc, (tpp, lab, ids, valid) = next(feed)
        if tracer is None or time.perf_counter() < slice0:
            steps.train_step(acc, tpp, lab, ids, valid, pos_weight,
                             pipe.generator)
            n += 1
            continue
        if tracer.prof is None:
            _sync(run)
            t_plain, n_plain = time.perf_counter(), n
            tracer.start()
        ta = time.perf_counter()
        with torch.profiler.record_function("fetch"):
            neighbors, _ = steps.fetch(tpp, ids)
            _sync(run)
        tb = time.perf_counter()
        with torch.profiler.record_function("forward_backward"):
            loss, logits, grads = steps.forward_backward(
                neighbors, tpp, lab, valid, pos_weight, pipe.generator)
            _sync(run)
        tc = time.perf_counter()
        with torch.profiler.record_function("apply"):
            steps.apply(acc, neighbors, lab, valid, loss, logits, grads)
            _sync(run)
        td = time.perf_counter()
        stage["retrieve_ms"].append((tb - ta) * 1e3)
        stage["forward_backward_ms"].append((tc - tb) * 1e3)
        stage["update_ms"].append((td - tc) * 1e3)
        n += 1
    _sync(run)
    t_end = time.perf_counter()
    if tracer is not None and tracer.running:
        tracer.stop()
        run.trace_summary = tracer.summary
        run.note(tracer.describe())
    run.e2e["train_steps_per_s"] = n / (t_end - t0)
    run.attempted, run.failed = n, 0
    run.spans.update(stage)
    plain_s = (t_plain if t_plain is not None else t_end) - t0
    plain_n = n_plain if t_plain is not None else n
    run.counters["plain_steps"] = plain_n
    run.counters["plain_s"] = plain_s
    run.counters["model_flops"] = plain_n * 3 * b * counts.fusion_flops(cfg)
    run.counters["searches"] = pipe.index.searches
    run.counters["fallbacks"] = pipe.index.fallbacks
    run.note(f"train: {n} steps in {t_end - t0:.3f} s, certificate "
             f"fallbacks {pipe.index.fallbacks} of {pipe.index.searches}")

    losses_p = [float(x) for x in losses]
    change_p = {k: theta3[k] - theta0[k] for k in theta0}
    _sync(run)
    if dev != "cpu":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    del pipe, steps, feed, params, theta3, theta0
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    for name, val in judge(run, losses_p, given1, change_p).items():
        run.checks.append((name, val, cfg["limits"]["train"][name]))
    shutil.rmtree(scratch, ignore_errors=True)


MAX_TIED = 5  # queries tied at the k-th neighbor the check follows both ways


def judge(run: Run, losses, given1, change) -> dict:
    """The three numbers against the float64 reference, which follows each
    way a float32 search may break the ties at the k-th neighbor (every
    combination, up to ``MAX_TIED`` tied queries) and keeps the way whose
    losses lie nearest."""
    ties = tied_queries(run)
    if len(ties) > MAX_TIED:
        run.note(f"{len(ties)} queries tied at the k-th neighbor; the "
                 f"check follows the first {MAX_TIED} both ways")
    ties = ties[:MAX_TIED]
    best = None
    for mask in range(2 ** len(ties)):
        swaps = [t for j, t in enumerate(ties) if mask >> j & 1]
        ref = follow(run, swaps=swaps)
        nums = check.judge_train(losses, given1, change, ref["losses"],
                                 ref["given1"], ref["change"], ref["grad1"])
        if best is None or nums["loss_gap"] < best[0]["loss_gap"]:
            best = (nums, swaps)
    if ties:
        run.note(f"tied queries (step, row): {ties}; followed: {best[1]}")
    return best[0]


def first_batches(n_rows: int, batch: int, seed: int, steps: int = 3):
    """The rows of epoch 1's first batches: the order shuffled by
    ``np.random.default_rng(seed)``, as the program's loader shuffles."""
    order = np.arange(n_rows)
    np.random.default_rng(seed).shuffle(order)
    return [order[i * batch:(i + 1) * batch] for i in range(steps)]


def _inputs(run: Run):
    rows, labels = _rows(run)
    ids = torch.as_tensor([file_id(x) for x in _names(rows.shape[0])],
                          dtype=torch.int64, device=run.device)
    batches = [torch.as_tensor(x, device=run.device) for x in first_batches(
        rows.shape[0], run.config["pipeline"]["batch_size"], run.seed)]
    return rows, labels, ids, batches


def tied_queries(run: Run):
    rows, _, ids, batches = _inputs(run)
    return RT.tied(rows, ids, batches, run.config["pipeline"]["top_k"])


def follow(run: Run, kind: str = "exact", fault=None,
           dtype=torch.float64, swaps=()):
    """The reference's first three steps from the harness's inputs (the
    configuration's optimizer settings; the run's seed, which the program
    gets as its ``random_seed``, for the shuffle and the dropout masks)."""
    cfg, dev, seed = run.config, run.device, run.seed
    rows, labels, ids, batches = _inputs(run)
    p = cfg["pipeline"]
    return RT.follow(
        W.fusion_weights(cfg, seed, dev), rows, labels, ids, batches,
        pos_weight=RT.pos_weight_of(labels), k=p["top_k"],
        lr=p["learning_rate"], wd=p["weight_decay"],
        dropout=p["projection_dropout"], generator_seed=seed,
        n_hidden=len(p["detection_hidden_dims"]), dtype=dtype, kind=kind,
        fault=fault, swaps=swaps)
