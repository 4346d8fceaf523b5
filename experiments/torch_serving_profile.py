#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's serving path, on one GPU.

Builds the same full-width serving setup as ``chip_smoke.py`` (seeded
random wav2vec2-base, 256 synthetic clips embedded, index padded to
25,600 x 5,376), then for ``predict_batch`` at B = 1, 8 and 64:

* a stage breakdown from CUDA-synchronized host clocks: decode, embed
  (segment + encoder + TPP), certified search, neighbor gather, fusion
  model, payload;
* a ``torch.profiler`` trace of one call: device time summed by kernel
  (the top entries and the port's three kernels) and the device's busy
  share of the call's wall time.

Run from the root of a checkout on a machine with a GPU:
``python3 experiments/torch_serving_profile.py [--out FILE]``. Prints text;
writes the per-kernel tables to ``FILE`` (default
``runs/torch_serving_profile.txt``).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _stages(torch, pipe, paths, reps=5):
    """Median milliseconds per stage of one predict_batch's work, each
    stage ended by a device synchronize."""
    import numpy as np

    from radad_tpu_torch.data.audio import load_audio
    from radad_tpu_torch.data.manifest import file_id
    from radad_tpu_torch.index.flat import _search_device
    from radad_tpu_torch.ops.gather import gather_rows

    cfg, ix = pipe.config, pipe.index
    rows = {k: [] for k in ("decode", "embed", "search", "gather", "model")}
    for _ in range(reps):
        t0 = time.perf_counter()
        waves = np.stack([load_audio(p, sample_rate=cfg.sample_rate,
                                     duration=cfg.clip_duration)
                          for p in paths])
        excl = torch.as_tensor([file_id(p) for p in paths],
                               dtype=torch.int32, device=ix.device)
        audio = torch.as_tensor(waves, device=ix.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tpp = pipe._embed(audio)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            _, idx, _ = _search_device(
                tpp, ix.vectors, ix.ids, excl, cfg.top_k, metric=ix.metric,
                n_valid=ix.ntotal, xsq=ix.norms_sq, scan_bf16=ix.scan_bf16,
                resid_bf16=ix.resid_bf16, exclude_mode="self")
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            nb = gather_rows(ix.vectors, idx.clamp_min(0).reshape(-1))
            nb = nb.reshape(idx.shape + (ix.dimension,))
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            pipe.model(nb, tpp)
            torch.cuda.synchronize()
            t5 = time.perf_counter()
        for k, a, b in (("decode", t0, t1), ("embed", t1, t2),
                        ("search", t2, t3), ("gather", t3, t4),
                        ("model", t4, t5)):
            rows[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in rows.items()}


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        "runs", "torch_serving_profile.txt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    card, dev = cs.header(torch)
    out_lines = [f"card: {card}"]
    with tempfile.TemporaryDirectory(prefix="radad_prof_") as tmp:
        import numpy as np

        from radad_tpu_torch.config import Config
        from radad_tpu_torch.data.manifest import Manifest, file_id
        from radad_tpu_torch.train.pipeline import DetectionPipeline

        cfg = Config().replace(
            data_root=tmp, vector_db_path=os.path.join(tmp, "vdb"),
            train_data_path=os.path.join(tmp, "db"), use_layer_norm=True,
            use_batch_norm=False, random_seed=cs.SEED)
        os.makedirs(cfg.train_data_path)
        pipe = DetectionPipeline(cfg, device=dev)
        db_paths, db_labels = cs._write_clips(cfg.train_data_path,
                                              cs.DB_CLIPS, cs.SEED, "db")
        pipe.build_vector_database(Manifest(
            paths=tuple(db_paths), labels=np.asarray(db_labels, np.float32),
            speakers=tuple("" for _ in db_paths),
            ids=np.asarray([file_id(p) for p in db_paths], np.int32)),
            save=False)
        cs._pad_index(torch, pipe, cs.INDEX_ROWS, cs.SEED + 1)
        q_paths, _ = cs._write_clips(tmp, 64, cs.SEED + 2, "query")
        pipe.predict_batch(q_paths[:8])  # warm-up
        for b in (1, 8, 64):
            paths = q_paths[:b]
            st = _stages(torch, pipe, paths)
            line = (f"B={b} stages (median of 5, ms): "
                    + ", ".join(f"{k} {v:.3f}" for k, v in st.items()))
            print(line)
            out_lines.append(line)
            pipe.predict_batch(paths)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                pipe.predict_batch(paths)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            events = [e for e in prof.key_averages()
                      if getattr(e, "device_time_total", 0) > 0
                      and getattr(getattr(e, "device_type", None), "name", "") == "CUDA"]
            busy = sum(e.device_time_total for e in events) / 1e3
            line = (f"B={b} profiled predict_batch: wall {wall:.3f} ms, "
                    f"kernel time {busy:.3f} ms (device busy share "
                    f"{busy / wall:.3f})")
            print(line)
            out_lines.append(line)
            events.sort(key=lambda e: -e.device_time_total)
            ours = ("gather_rows_kernel", "exact_dot_kernel",
                    "extract_candidates_kernel")
            for e in events:
                if events.index(e) < 12 or any(o in e.key for o in ours):
                    line = (f"  {e.device_time_total / 1e3:9.4f} ms "
                            f"x{e.count:<4d} {e.key[:100]}")
                    print(line)
                    out_lines.append(line)
        print(f"fallbacks {pipe.index.fallbacks} of "
              f"{pipe.index.searches} searches")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(out_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
