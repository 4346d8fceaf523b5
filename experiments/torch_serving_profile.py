#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's serving path, on one GPU.

Builds the same full-width serving setup as ``chip_smoke.py`` (seeded
random wav2vec2-base, wavlm-base or whisper-base, 256 synthetic clips
embedded, index padded to 25,600 rows of TPP width: 5,376, or 3,584 for
whisper-base), then for ``predict_batch`` at B = 1, 8 and 64:

* a stage breakdown from CUDA-synchronized host clocks: decode, embed
  (segment + encoder + TPP), search, neighbor gather, fusion model;
* a ``torch.profiler`` trace of one call: device time summed by kernel
  (the top entries and the port's five kernels) and the device's busy
  share of the call's wall time.

Run from the root of a checkout on a machine with a GPU:
``python3 experiments/torch_serving_profile.py [--path wavlm|whisper]
[--whisper_fast] [--out FILE] [--mixed_precision]``. ``--path`` picks one
of ``chip_smoke.py``'s serving paths: ``wav2vec2`` (default; certified
search, default attention), ``wavlm`` (``use_pallas=True``,
``RADAD_FUSED_ATTENTION=1``) or ``whisper`` (certified search; every 2 s
window padded to 30 s unless ``--whisper_fast``; the attention fused only
if the caller sets ``RADAD_FUSED_ATTENTION=1``);
``--mixed_precision`` runs it with bf16 encoder and fusion model. Prints text; writes
the per-kernel tables to ``FILE`` (default
``runs/torch_serving_profile.txt``).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=("wav2vec2", "wavlm", "whisper"),
                    default="wav2vec2")
    ap.add_argument("--whisper_fast", action="store_true",
                    help="whisper: the real frames only, not 30 s padding")
    ap.add_argument("--mixed_precision", action="store_true",
                    help="bf16 encoder and fusion model "
                         "(use_mixed_precision=True)")
    ap.add_argument("--out", default=os.path.join(
        "runs", "torch_serving_profile.txt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    card, dev = cs.header(torch)
    wavlm = args.path == "wavlm"
    if wavlm:
        os.environ["RADAD_FUSED_ATTENTION"] = "1"
    out_lines = [f"card: {card}", f"path {args.path}, mixed precision "
                                  f"{args.mixed_precision}, whisper_fast "
                                  f"{args.whisper_fast}, "
                                  f"RADAD_FUSED_ATTENTION="
                                  f"{os.environ.get('RADAD_FUSED_ATTENTION')}"]
    with tempfile.TemporaryDirectory(prefix="radad_prof_") as tmp:
        pipe, _ = cs._build_pipeline(
            torch, dev, tmp, "profile", feature_extractor_type=args.path,
            use_pallas=wavlm, use_mixed_precision=args.mixed_precision,
            whisper_pad_seconds=None if args.whisper_fast else 30.0)
        q_paths, _ = cs._write_clips(tmp, 64, cs.SEED + 2, "query")
        pipe.predict_batch(q_paths[:8])  # warm-up
        for b in (1, 8, 64):
            paths = q_paths[:b]
            st = cs.stage_ms(torch, pipe, paths)
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
                    "exact_dot_split_kernel", "extract_candidates_kernel",
                    "mha_kernel", "mha_bf16_wgmma_kernel",
                    "mha_bf16_streamed_kernel", "mha_bf16_resident_kernel",
                    "mha_bf16_resident_wgmma_kernel",
                    "flat_topk")  # its bf16 body, q rounding and f32 body
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
