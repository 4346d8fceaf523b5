#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``radad_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit, the precision flags, and builds
   every CUDA kernel of the serving path from ``radad_tpu_torch/csrc``;
2. holds each kernel against its plain PyTorch version on the card at the
   serving path's shapes and takes the device time (``torch.profiler``) of
   kernel, plain version, and one PyTorch library call computing the same
   function (``library_ms``, used nowhere in the port);
3. drives the serving path at full width: a ``DetectionPipeline`` with a
   seeded random wav2vec2-base encoder (12 layers, 768 wide, f32) builds
   its DB from synthetic clips, the index is padded with seeded rows to
   25,600 x 5,376 (In-the-Wild scale), then ``predict`` on 1 clip and
   ``predict_batch`` on 8 and 64 clips; neighbor ids must equal an f32
   full scan and every kernel's launch counter must have moved;
4. starts the port's HTTP server on localhost and posts 3 WAV uploads to
   ``/api/predict``.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernel table. Any failure exits non-zero and prints no result. It
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores
SEED = 0
DB_CLIPS = 256  # synthetic clips embedded through build_vector_database
INDEX_ROWS = 25_600  # In-the-Wild scale (25,423 clips)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device milliseconds per call: the time of every kernel and
    copy ``fn`` runs on the card, summed by ``torch.profiler`` over
    ``iters`` calls (host launch gaps excluded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if getattr(getattr(e, "device_type", None), "name", "")
                   == "CUDA")
    if total_us <= 0:
        raise RuntimeError("the profiler saw no device time")
    return total_us / 1e3 / iters


def timings(torch, kernel, plain, library, iters: int = 20) -> dict:
    """Device ms per call of the kernel, its plain version and the library
    call, plus the kernel wrapper's per-call time on the CUDA-event clock
    (``call_ms``: back-to-back calls, host launch overhead included)."""
    return dict(ms=device_ms(torch, kernel, iters),
                plain_ms=device_ms(torch, plain, iters),
                library_ms=device_ms(torch, library, iters),
                call_ms=time_ms(torch, kernel, iters))


def bound_ms(nbytes: float, flops: float = 0.0):
    """(least ms for the card to move ``nbytes`` and do ``flops`` f32
    operations, which of the two bounds it)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3, (
        "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
        else "operations")


def header(torch):
    """Card, versions and precision flags; builds every kernel."""
    from radad_tpu_torch.ops import _native
    from radad_tpu_torch.utils.device import resolve_device

    card = _card_line()
    dev = resolve_device("cuda")  # also sets the precision flags
    print(card)  # nvidia-smi's name,power.limit line as it printed it
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    print("precision: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} "
          "matmul.allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    secs = _native.build()
    print(f"kernel build: {secs:.2f} s for {list(_native.SOURCES)}")
    for name in _native.SOURCES:
        for line in _native.build_reports.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    return card, dev


def kernel_phase(torch, dev):
    """Each kernel against its plain version at the serving path's shapes.
    Returns {name: record} without the launch counts."""
    from radad_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from radad_tpu_torch.ops.rerank import exact_dot, exact_dot_plain
    from radad_tpu_torch.ops.topk import (extract_candidates,
                                          extract_candidates_plain)

    g = torch.Generator(device=dev).manual_seed(SEED)
    n, d = 25_600, 5_376
    table = torch.randn((n, d), generator=g, device=dev)
    recs = {}

    # gather_rows: M = 1280 neighbor rows (B = 256 queries x top-5), with
    # out-of-range ids that both versions clamp
    m = 1_280
    idx = torch.randint(0, n, (m,), generator=g, device=dev,
                        dtype=torch.int32)
    idx[:3] = torch.tensor([-1, n, n + 7], device=dev, dtype=torch.int32)
    got = gather_rows(table, idx)
    want = gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("gather_rows differs from its plain version")
    idx_long = idx.long().clamp(0, n - 1)
    recs["gather_rows"] = dict(
        route="cuda", source="radad_tpu_torch/csrc/gather_rows.cu",
        replaces="radad_tpu/ops/gather.py:96", max_abs_err=0.0,
        tolerance="bit-equal",
        **timings(torch, lambda: gather_rows(table, idx),
                  lambda: gather_rows_plain(table, idx),
                  lambda: torch.index_select(table, 0, idx_long)),
        shape=f"x [{n},{d}] f32, idx [{m}]")
    # bytes this run's ids need: each distinct source row read once, every
    # output row written once, the ids read once
    rows_read = int(torch.unique(idx_long).numel())
    recs["gather_rows"]["bound_ms"], recs["gather_rows"]["bound_by"] = \
        bound_ms((rows_read + m) * d * 4 + m * 4)

    # exact_dot: B = 256 queries x R = 32 candidates, f32 and bf16 rows.
    # Tolerance: f32 summation order, |err| <= 1e-5 * sum_d |q_d x_d|.
    b, r = 256, 32
    q = torch.randn((b, d), generator=g, device=dev)
    cidx = torch.randint(0, n, (b, r), generator=g, device=dev,
                         dtype=torch.int32)
    table_bf16 = table.to(torch.bfloat16)
    errs = {}
    for name, x in (("f32", table), ("bf16", table_bf16)):
        got = exact_dot(q, x, cidx)
        want = exact_dot_plain(q, x, cidx)
        scale = (x[cidx.long()].float().abs()
                 * q.abs()[:, None, :]).sum(-1)
        torch.cuda.synchronize()
        err = (got - want).abs()
        if not bool((err <= 1e-5 * scale).all()):
            raise AssertionError(f"exact_dot[{name}] outside tolerance: "
                                 f"max err {float(err.max())}")
        errs[name] = float(err.max())
    print(f"exact_dot max_abs_err: f32 {errs['f32']:.3e}, "
          f"bf16 {errs['bf16']:.3e} (tolerance 1e-5 * sum|q*x|)")
    bf16_ms = device_ms(torch, lambda: exact_dot(q, table_bf16, cidx))
    bf16_bound = bound_ms(int(torch.unique(cidx).numel()) * d * 2 + b * d * 4
                          + 2 * b * r * 4, 2.0 * b * r * d)[0]
    print(f"exact_dot bf16 rows: {bf16_ms:.4f} ms on the device, bound "
          f"{bf16_bound:.4f} ms")
    recs["exact_dot"] = dict(
        route="cuda", source="radad_tpu_torch/csrc/exact_dot.cu",
        replaces="radad_tpu/ops/rerank.py:131", max_abs_err=errs["f32"],
        tolerance="1e-5 * sum|q*x| (f32 summation order)",
        **timings(torch, lambda: exact_dot(q, table, cidx),
                  lambda: exact_dot_plain(q, table, cidx),
                  lambda: torch.bmm(table[cidx.long()], q[:, :, None])),
        shape=f"q [{b},{d}] f32, x [{n},{d}] f32, idx [{b},{r}]")
    # each distinct candidate row read once, q and the ids read, out written
    rows_read = int(torch.unique(cidx).numel())
    recs["exact_dot"]["bound_ms"], recs["exact_dot"]["bound_by"] = bound_ms(
        rows_read * d * 4 + b * d * 4 + 2 * b * r * 4, 2.0 * b * r * d)

    # extract_candidates: B = 256, T = 24 tiles of 128 lanes, m = 8 rounds,
    # with exact ties and all-(-inf) tiles
    t, mm, nt = 24, 8, n // 128
    cand = torch.randn((b, t, 128), generator=g, device=dev)
    cand[0, 0, :] = float("-inf")
    cand[5, 3, :] = float("-inf")
    cand[1, t - 1, 7] = cand[1, t - 1, 99]
    cand[2, 4, :] = 0.5  # a whole tile tied
    cand[3, 2, 10:20] = float("-inf")
    tsel = torch.randint(0, nt, (b, t), generator=g, device=dev,
                         dtype=torch.int32)
    got = extract_candidates(cand, tsel, mm, nt)
    want = extract_candidates_plain(cand, tsel, mm, nt)
    torch.cuda.synchronize()
    for gv, wv, what in zip(got, want, ("vals", "rows", "leftover")):
        if not torch.equal(gv, wv):
            raise AssertionError(f"extract_candidates {what} differs from "
                                 f"its plain version")
    recs["extract_candidates"] = dict(
        route="cuda", source="radad_tpu_torch/csrc/extract_candidates.cu",
        replaces="radad_tpu/ops/topk.py:338", max_abs_err=0.0,
        tolerance="bit-equal",
        **timings(torch, lambda: extract_candidates(cand, tsel, mm, nt),
                  lambda: extract_candidates_plain(cand, tsel, mm, nt),
                  lambda: torch.topk(cand, mm, dim=-1)),
        shape=f"cand [{b},{t},128] f32, m={mm}")
    # operations: per round and lane a max, a compare and a select
    out_bytes = b * mm * t * 8 + b * t * 4
    recs["extract_candidates"]["bound_ms"], \
        recs["extract_candidates"]["bound_by"] = bound_ms(
            b * t * 128 * 4 + b * t * 4 + out_bytes, 3.0 * b * t * 128 * mm)
    for name, rec in recs.items():
        print(f"kernel {name}: {rec['shape']}: device {rec['ms']:.4f} ms "
              f"(per call on the event clock {rec['call_ms']:.4f} ms), "
              f"plain {rec['plain_ms']:.4f} ms, library "
              f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), "
              f"max_abs_err {rec['max_abs_err']:.3e} ({rec['tolerance']})")
    del table, table_bf16
    torch.cuda.empty_cache()
    return recs


def _write_clips(tmp: str, n: int, seed: int, prefix: str):
    """``n`` seeded 3 s synthetic clips as 16-bit WAVs (two spectral
    classes, as the repo's synthetic test set) → (paths, labels)."""
    import numpy as np

    from radad_tpu_torch.data.audio import write_wav

    rng = np.random.default_rng(seed)
    sr, dur = 16_000, 3.0
    t = np.arange(int(sr * dur)) / sr
    paths, labels = [], []
    for i in range(n):
        spoof = i % 3 != 0
        freq = rng.uniform(120.0, 600.0)
        wave = 0.4 * np.sin(2 * np.pi * freq * t + rng.uniform(0, 6.28))
        if spoof:
            wave += 0.3 * np.sin(2 * np.pi * 4 * freq * t)
        wave += 0.02 * rng.standard_normal(len(t))
        path = os.path.join(tmp, f"{prefix}_{i:04d}.wav")
        write_wav(path, wave.astype(np.float32), sr)
        paths.append(path)
        labels.append(1.0 if spoof else 0.0)
    return paths, labels


def _pad_index(torch, pipe, n_rows: int, seed: int) -> None:
    """Pad the index to ``n_rows`` with seeded rows around the real clip
    embeddings: one contiguous block of 32 tight clusters x 32 near-
    duplicates (manifest order puts similar clips side by side), the rest
    wider perturbations."""
    ix = pipe.index
    dev = ix.device
    g = torch.Generator(device=dev).manual_seed(seed)
    real = ix.vectors[: ix.n].float()
    std = real.std(0, keepdim=True)
    centers = real[torch.randint(0, ix.n, (32,), generator=g, device=dev)]
    block = (centers.repeat_interleave(32, 0) + 0.05 * std
             * torch.randn((1024, real.shape[1]), generator=g, device=dev))
    rest = n_rows - ix.n - block.shape[0]
    base = real[torch.randint(0, ix.n, (rest,), generator=g, device=dev)]
    wide = base + 0.5 * std * torch.randn((rest, real.shape[1]),
                                          generator=g, device=dev)
    rows = torch.cat([block, wide])
    names = [f"pad_{i:06d}.wav" for i in range(rows.shape[0])]
    labels = (torch.rand((rows.shape[0],), generator=g, device=dev)
              > 0.5).float().tolist()
    ix.add(rows, labels, names)


def _check_against_full_scan(torch, pipe, paths, outs):
    """Neighbors of ``outs`` (a predict_batch result) against a full scan
    on the card over the same embeddings, with per-row self exclusion, in
    f64. Ids must be identical, except that neighbors whose f64 squared
    distances differ by less than f32 rounding, 2^-21 * (|q|^2 + max |x|^2)
    (the certified search scores ``|q|^2 - 2 q.x + |x|^2`` in f32), may
    swap: there the returned distances must equal the f64 top-k within
    that bound. Returns (rows with identical ids, rows where an f32 GEMM
    full scan's ids differ from the f64 ones)."""
    import numpy as np

    from radad_tpu_torch.data.audio import load_audio
    from radad_tpu_torch.data.manifest import file_id
    from radad_tpu_torch.index.flat import _full_scan, top_k_stable

    cfg, ix = pipe.config, pipe.index
    k = cfg.top_k
    waves = np.stack([load_audio(p, sample_rate=cfg.sample_rate,
                                 duration=cfg.clip_duration) for p in paths])
    tpp = pipe._embed(torch.as_tensor(waves, device=ix.device))
    excl = torch.as_tensor([file_id(p) for p in paths], device=ix.device,
                           dtype=torch.int32)
    invalid = torch.arange(ix.vectors.shape[0], device=ix.device) >= ix.n
    mask = invalid[None, :] | (ix.ids[None, :] == excl[:, None])
    q64, x64 = tpp.double(), ix.vectors.double()
    qsq, xsq = q64.square().sum(-1), x64.square().sum(-1)
    d64 = (qsq[:, None] - 2.0 * q64 @ x64.t() + xsq[None, :]).masked_fill(
        mask, float("inf"))
    neg_ref, ref = top_k_stable(-d64, k)
    _, ref32 = _full_scan(tpp, ix.vectors, ix.norms_sq, mask, k,
                          larger_better=False)
    name_to_row = {os.path.basename(p): i for i, p in enumerate(ix.paths)}
    got = torch.as_tensor([[name_to_row[f] for f in o["retrieved_files"]]
                           for o in outs], device=ix.device)
    d_got = d64.gather(1, got).sort(-1).values
    tol = 2.0 ** -21 * (qsq + xsq[: ix.n].max())
    worst = float(((d_got + neg_ref).abs() - tol[:, None]).max())
    if worst > 0:
        raise AssertionError(f"neighbors beyond f32 rounding of the f64 "
                             f"top-{k} (excess {worst:.3e})")
    if not all(np.isfinite(o["logit"]) for o in outs):
        raise AssertionError("non-finite logit")
    same = int((got == ref).all(-1).sum())
    return same, int((ref32.long() != ref).any(-1).sum())


def serving_phase(torch, dev, tmp: str):
    """The serving path at full width. Returns (pipeline, launches on the
    counted run, query clip paths)."""
    import numpy as np

    from radad_tpu_torch.config import Config
    from radad_tpu_torch.data.manifest import Manifest, file_id
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    cfg = Config().replace(
        data_root=tmp, vector_db_path=os.path.join(tmp, "vdb"),
        train_data_path=os.path.join(tmp, "db"), use_layer_norm=True,
        use_batch_norm=False, random_seed=SEED)
    os.makedirs(cfg.train_data_path)
    t0 = time.perf_counter()
    pipe = DetectionPipeline(cfg, device=dev)
    enc = pipe.encoder.arch_cfg
    print(f"pipeline: wav2vec2 {enc.num_hidden_layers} layers x "
          f"{enc.hidden_size} wide, pretrained={pipe.encoder.pretrained}, "
          f"tpp dim {pipe.tpp_dim}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    db_paths, db_labels = _write_clips(cfg.train_data_path, DB_CLIPS, SEED,
                                       "db")
    manifest = Manifest(
        paths=tuple(db_paths), labels=np.asarray(db_labels, np.float32),
        speakers=tuple(f"spk{i % 8}" for i in range(len(db_paths))),
        ids=np.asarray([file_id(p) for p in db_paths], np.int32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.build_vector_database(manifest, save=False)
    torch.cuda.synchronize()
    print(f"build_vector_database: {len(db_paths)} clips in "
          f"{time.perf_counter() - t0:.2f} s")
    _pad_index(torch, pipe, INDEX_ROWS, SEED + 1)
    ix = pipe.index
    print(f"index: {ix.ntotal} x {ix.dimension} {ix.metric}, capacity "
          f"{ix.vectors.shape[0]}, device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    q_paths, _ = _write_clips(tmp, 64, SEED + 2, "query")
    batch64 = q_paths[:32] + db_paths[:32]  # half of them are DB clips
    pipe.predict(q_paths[0])  # warm-up outside the counted run
    pipe.predict_batch(q_paths[:8])
    torch.cuda.synchronize()

    kernels = (gather_rows, exact_dot, extract_candidates)
    for w in kernels:
        w.launches = 0
    ix.searches = ix.fallbacks = 0
    lat = {"predict_1": [], "predict_batch_8": [], "predict_batch_64": []}
    stages = {}
    for _ in range(5):
        t = time.perf_counter()
        single = pipe.predict(q_paths[1])
        lat["predict_1"].append((time.perf_counter() - t) * 1e3)
    for name, paths, reps in (("predict_batch_8", q_paths[8:16], 5),
                              ("predict_batch_64", batch64, 3)):
        for _ in range(reps):
            t = time.perf_counter()
            outs = pipe.predict_batch(paths)
            lat[name].append((time.perf_counter() - t) * 1e3)
        stages[name] = outs[0]["stage_ms"]
        same, f32_rows = _check_against_full_scan(torch, pipe, paths, outs)
        print(f"{name}: neighbors match the f64 full scan on all "
              f"{len(paths)} rows, ids identical on {same} (the rest swap "
              f"neighbors tied within f32 rounding); an f32 GEMM full "
              f"scan's ids differ from f64 on {f32_rows} rows")
    launches = {w.__name__: w.launches for w in kernels}
    calls = sum(len(v) for v in lat.values())
    if not np.isfinite(single["logit"]):
        raise AssertionError("non-finite logit from predict")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serving path")
    summary = {name: {"p50_ms": float(np.median(v)), "runs_ms": v}
               for name, v in lat.items()}
    for name, v in summary.items():
        print(f"{name}: p50 {v['p50_ms']:.2f} ms over "
              f"{len(v['runs_ms'])} runs "
              f"{[round(x, 2) for x in v['runs_ms']]}, stage_ms "
              f"{stages.get(name, '-')}")
    print(f"serving path: {calls} calls, {ix.searches} certified searches, "
          f"{ix.fallbacks} fallbacks to the full f32 scan; kernel launches "
          f"{launches}")
    return pipe, launches, q_paths


def server_phase(pipe, q_paths) -> None:
    """The port's HTTP server on localhost: 3 WAV uploads to /api/predict."""
    import threading
    import urllib.request

    from radad_tpu_torch.serve.app import serve

    httpd = serve(pipe.config, host="127.0.0.1", port=0, pipeline=pipe)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for path in q_paths[40:43]:
            with open(path, "rb") as f:
                wav = f.read()
            boundary = "radadsmokeboundary"
            body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                    f"name=\"file\"; filename=\"{os.path.basename(path)}\""
                    f"\r\nContent-Type: audio/wav\r\n\r\n").encode() \
                + wav + f"\r\n--{boundary}--\r\n".encode()
            req = urllib.request.Request(
                base + "/api/predict", data=body, method="POST",
                headers={"Content-Type":
                         f"multipart/form-data; boundary={boundary}"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                status = resp.status
                out = json.loads(resp.read())
            ms = (time.perf_counter() - t) * 1e3
            if status != 200 or not out.get("ok"):
                raise AssertionError(f"/api/predict answered {status}: {out}")
            missing = {"prediction", "probability", "probability_spoof",
                       "neighbors", "timings_ms"} - set(out)
            if missing or len(out["neighbors"]) != pipe.config.top_k:
                raise AssertionError(f"/api/predict payload lacks {missing}")
            print(f"server: POST /api/predict {status} in {ms:.2f} ms, "
                  f"prediction {out['prediction']}, timings_ms "
                  f"{out['timings_ms']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import radad_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import radad_tpu_torch ({e}); run from "
              f"the root of a checkout", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card, dev = header(torch)
    recs = kernel_phase(torch, dev)
    with tempfile.TemporaryDirectory(prefix="radad_smoke_") as tmp:
        pipe, launches, q_paths = serving_phase(torch, dev, tmp)
        server_phase(pipe, q_paths)
    kernels = [dict(name=name, route=r["route"], source=r["source"],
                    replaces=r["replaces"], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for name, r in recs.items()]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
