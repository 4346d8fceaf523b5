#!/usr/bin/env python3
"""Device time of ``csrc/flat_topk.cu``'s bf16 body and of variants of it,
on one GPU, at the serving shape (25,600 x 5,376 f32 rows, r = 32, L2).

Each variant is the committed source with one line replaced, built by its
own ``nvcc`` (the port's flags) into ``radad_tpu_torch/build/variants/``
and called through its C entry, without the wrapper's merge:

* ``as_built``: the source as it is (a ring of 2 stages of 64 columns,
  256 contiguous bytes of an f32 row a stage);
* ``mc32_stages4``: 4 stages of 32 columns (128 bytes);
* ``mc48_stages3``: 3 stages of 48 columns (192 bytes);
* ``stream_only``: no products (the k16 loop runs 0 times): the ring
  streams the table and the select stage runs, the kernel's floor;
* ``no_select``: the bf16 body without its select stage (the scan and the
  score tile only), so ``as_built`` minus it is the select's cost.

Times are CUDA-event means over back-to-back launches, taken in turns
(as_built, variant, variant, as_built) at B = 1, 8 and 64. Run from the
root of a checkout: ``python3 experiments/flat_topk_variants.py [--out
FILE]``; it prints a table and writes it to ``FILE`` (default
``runs/flat_topk_variants.txt``).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

STAGES = "constexpr int kStages = 2;"
WIDTH = "constexpr int kMC = 64;"
NO_PRODUCTS = ("for (int kk = 0; kk < kMC; kk += 16) {",
               "for (int kk = 0; kk < 0; kk += 16) {")
VARIANTS = {  # name -> (old line, new line) swaps
    "as_built": (),
    "mc32_stages4": ((STAGES, "constexpr int kStages = 4;"),
                     (WIDTH, "constexpr int kMC = 32;")),
    "mc48_stages3": ((STAGES, "constexpr int kStages = 3;"),
                     (WIDTH, "constexpr int kMC = 48;")),
    "stream_only": (NO_PRODUCTS,),
    "no_select": (("  select_tile(scores, kSS, q0, b_total, row0, tile, tiles, "
                   "r, out_vals, out_idx);", ""),),
}


def build_variants() -> dict:
    """name -> loaded library of every variant, built in parallel."""
    from radad_tpu_torch.ops import _native

    src = open(os.path.join(_native.CSRC_DIR, "flat_topk.cu")).read()
    out_dir = os.path.join(_native.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, swap in VARIANTS.items():
        text = src
        for old, new in swap:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: '{old}' not found once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"flat_topk_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libflat_topk_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        report = (out + err).splitlines()
        for i, line in enumerate(report):  # the bf16 body's f32-row L2 entry
            if "flat_topk_kernelIfLb1E" in line:
                print(f"ptxas[{name}]: " + " | ".join(
                    x.strip() for x in report[i + 1: i + 4]))
        libs[name] = ctypes.CDLL(lib)
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        "runs", "flat_topk_variants.txt"))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from radad_tpu_torch.ops import _native

    card, dev = cs.header(torch)
    libs = build_variants()
    n, d, r = 25_600, 5_376, 32
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((n, d), generator=g, device=dev)
    lines = [f"card: {card}", f"x [{n},{d}] f32, r={r}, L2, bf16 body, "
             f"CUDA-event ms per launch (no merge), {args.iters} launches"]
    for b in (1, 8, 64):
        q = torch.randn((b, d), generator=g, device=dev)
        tiles = -(-n // 128)
        qb = torch.empty((b, -(-d // 192) * 192), dtype=torch.bfloat16,
                         device=dev)  # whole stages of every variant
        vals = torch.empty((b, tiles, r), device=dev)
        idx = torch.empty((b, tiles, r), dtype=torch.int32, device=dev)

        def call(lib):
            fn = lib.radad_flat_topk
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def go():
                rc = fn(q.data_ptr(), qb.data_ptr(), table.data_ptr(), None,
                        None, vals.data_ptr(), idx.data_ptr(), b, n, n, d, r,
                        0, 1, 1, _native.stream_of(q))
                _native.check_launch("flat_topk variant", rc)
            return go

        base = call(libs["as_built"])
        bound = cs.bound_ms(n * d * 4 + b * d * 4 + b * tiles * r * 8,
                            2.0 * b * n * d, rate=cs.BF16_FLOPS)[0]
        row = {}
        for name, lib in libs.items():
            if name == "as_built":
                continue
            v = call(lib)
            t = [cs.time_ms(torch, f, iters=args.iters)
                 for f in (base, v, v, base)]
            row["as_built"] = row.get("as_built", []) + [t[0], t[3]]
            row[name] = [t[1], t[2]]
        line = f"B={b} (bound {bound:.4f} ms): " + ", ".join(
            f"{k} {sum(v) / len(v):.4f} ms {[round(x, 4) for x in v]}"
            for k, v in row.items())
        print(line)
        lines.append(line)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
