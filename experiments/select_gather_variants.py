#!/usr/bin/env python3
"""Device time of ``csrc/gather_rows.cu`` and ``csrc/extract_candidates.cu``
against the designs they were measured against, on one GPU, at the serving
shapes: ``gather_rows`` over a 25,600 x 5,376 f32 table at M = 5, 32, 40,
256, 320, 1,280 and 2,048 rows (5 B neighbor rows and 32 B re-rank rows at
B = 1, 8, 64, and 5 B at B = 256), ``extract_candidates`` at B = 1, 8, 64
and 256 queries of T = 24 tiles, m = 8.

Each variant is the committed source with a few lines replaced, built by
its own ``nvcc`` (the port's flags, all started together) into
``radad_tpu_torch/build/variants/`` and called through its C entry:

``gather_rows`` (vector design: kThreads threads a block, each issuing
kUnroll 16-byte loads before its stores, one block a (row, chunk)):

* ``as_built``: the committed constants, loads through the read-only path
  (``ld.global.nc``, which the script checks in the SASS);
* ``u1`` / ``u2`` / ``u8``: 1, 2 or 8 loads a thread; ``t64`` / ``t256``:
  64 or 256 threads a block; ``t64_u2``, ``t64_u8``, ``t256_u2``: both;
* ``no_l1`` / ``u2_no_l1``: the loads as inline-asm
  ``ld.global.nc.L1::no_allocate`` (skip L1); ``prefetch256``: as
  ``ld.global.nc.L2::256B`` (an L2 prefetch hint);
* ``streaming_stores``: the stores as ``st.global.cs`` (``__stcs``);
* ``bulk_4x8k`` / ``bulk_8x4k`` / ``bulk_2x16k``: the bulk-copy design of
  ``experiments/gather_rows_bulk.cu`` (one thread a block, cp.async.bulk
  global -> shared -> global, kStages chunks of kChunkBytes in flight).

Each timed gather reads its rows from device memory, as in
``chip_smoke.py`` (``chip_smoke.ColdRows``: the ids walk a random
permutation of the table's rows; each output is a new buffer, kept alive
in a ring of more than twice the L2).

``extract_candidates`` (one warp a tile, m rounds of redux.sync on int
keys, the rounds staged in shared memory and stored coalesced):

* ``as_built``: up to 16 tiles (warps) a block;
* ``shuffle``: each reduction a 5-step shuffle-xor chain instead of one
  redux.sync;
* ``direct``: lane 0 stores each round's value and row to device memory,
  T floats apart, with no staging;
* ``shuffle_direct``: both (the design of the first port);
* ``tiles4`` / ``tiles8`` / ``tiles32``: at most 4, 8 or 32 tiles a block;
* ``sorted``: each thread sorts its 4 keys once, a round reduces one head
  key a thread and the owner shifts its list (fewer operations a round);
  ``sorted_tiles8`` / ``sorted_tiles4``: with 8 or 4 tiles a block.

With ``--parent DIR`` (an unpacked checkout of an earlier commit) its two
sources join as ``parent``. Every variant must equal the plain version at
every shape. Times are the profiler's device time of the kernel
(``chip_smoke.device_ms``), the variants taken in order and then in reverse
order at each shape, beside ``index_select`` / ``topk``. Run from the root
of a checkout: ``python3 experiments/select_gather_variants.py [--out FILE]
[--parent DIR]``; it prints a table and writes it to ``FILE`` (default
``runs/select_gather_variants.txt``).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HERE = os.path.dirname(os.path.abspath(__file__))
LOAD_LINE = "    if (c < row_vecs) v[u] = src[c];"
ANCHOR = "// blockIdx.x: the output row; blockIdx.y: the chunk of it"


def asm_loads(op: str) -> tuple:
    """Swaps that route the kernel's loads through inline-asm ``op`` (a
    ``ld.global`` form) at each of its three widths."""
    defs = (
        "__device__ __forceinline__ uint4 load_once(const uint4* p) {\n"
        "  uint4 v;\n"
        f'  asm("{op}.v4.u32 {{%0, %1, %2, %3}}, [%4];"\n'
        '      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));\n'
        "  return v;\n}\n"
        "__device__ __forceinline__ uint32_t load_once(const uint32_t* p) {\n"
        f'  uint32_t v;\n  asm("{op}.u32 %0, [%1];" : "=r"(v) : "l"(p));\n'
        "  return v;\n}\n"
        "__device__ __forceinline__ uint16_t load_once(const uint16_t* p) {\n"
        f'  uint16_t v;\n  asm("{op}.u16 %0, [%1];" : "=h"(v) : "l"(p));\n'
        "  return v;\n}\n\n")
    return ((ANCHOR, defs + ANCHOR),
            (LOAD_LINE, "    if (c < row_vecs) v[u] = load_once(src + c);"))


SHUFFLE = (
    ("__device__ __forceinline__ int warp_max(int k) { return "
     "__reduce_max_sync(kFull, k); }",
     "__device__ __forceinline__ int warp_max(int k) {\n#pragma unroll\n"
     "  for (int o = 16; o > 0; o >>= 1) k = max(k, __shfl_xor_sync(kFull, "
     "k, o));\n  return k;\n}"),
    ("__device__ __forceinline__ unsigned warp_min(unsigned i) { return "
     "__reduce_min_sync(kFull, i); }",
     "__device__ __forceinline__ unsigned warp_min(unsigned i) {\n"
     "#pragma unroll\n  for (int o = 16; o > 0; o >>= 1) i = min(i, "
     "__shfl_xor_sync(kFull, i, o));\n  return i;\n}"),
)
DIRECT = (
    ("        s_val[j * w + warp] = key_value(best);\n"
     "        s_row[j * w + warp] = static_cast<int32_t>(bidx) * nt + tile;\n",
     "        const int64_t o = b * m * t + static_cast<int64_t>(j) * t + t0"
     " + warp;\n"
     "        vals[o] = key_value(best);\n"
     "        rows[o] = static_cast<int32_t>(bidx) * nt + tile;\n"),
    ("    if (lane == 0) s_left[warp] = key_value(rest);\n",
     "    if (lane == 0) leftover[b * t + t0 + warp] = key_value(rest);\n"),
    ("  __syncthreads();\n", "  return;\n"),
)
# sorted: each thread sorts its 4 keys once (largest first, the lower lane
# first among equals); a round reduces each thread's head, and the owner
# shifts its list. Once the best key is -inf every lane is -inf, and the
# XLA loop takes lane 0.
SORTED = (
    ("    const int32_t tile = tsel[tile_at];\n",
     "    unsigned l0 = 4 * lane, l1 = l0 + 1, l2 = l0 + 2, l3 = l0 + 3;\n"
     "    auto order = [](int& ka, unsigned& la, int& kb, unsigned& lb) {\n"
     "      if (kb > ka || (kb == ka && lb < la)) {\n"
     "        const int k = ka; ka = kb; kb = k;\n"
     "        const unsigned l = la; la = lb; lb = l;\n      }\n    };\n"
     "    order(k0, l0, k1, l1);\n    order(k2, l2, k3, l3);\n"
     "    order(k0, l0, k2, l2);\n    order(k1, l1, k3, l3);\n"
     "    order(k1, l1, k2, l2);\n"
     "    const int32_t tile = tsel[tile_at];\n"),
    ("      const int best = warp_max(max(max(k0, k1), max(k2, k3)));\n"
     "      unsigned mine = 128;\n"
     "      if (k3 == best) mine = 4 * lane + 3;\n"
     "      if (k2 == best) mine = 4 * lane + 2;\n"
     "      if (k1 == best) mine = 4 * lane + 1;\n"
     "      if (k0 == best) mine = 4 * lane;\n"
     "      const unsigned bidx = warp_min(mine);\n"
     "      if ((bidx >> 2) == static_cast<unsigned>(lane)) {\n"
     "        switch (bidx & 3) {\n"
     "          case 0: k0 = neg_inf; break;\n"
     "          case 1: k1 = neg_inf; break;\n"
     "          case 2: k2 = neg_inf; break;\n"
     "          default: k3 = neg_inf; break;\n"
     "        }\n"
     "      }\n",
     "      const int best = warp_max(k0);\n"
     "      const unsigned bidx = best == neg_inf ? 0u : warp_min(k0 == best ?"
     " l0 : 128u);\n"
     "      if (best != neg_inf && l0 == bidx) {\n"
     "        k0 = k1; l0 = l1; k1 = k2; l1 = l2; k2 = k3; l2 = l3;\n"
     "        k3 = neg_inf; l3 = 128;\n      }\n"),
    ("    const int rest = warp_max(max(max(k0, k1), max(k2, k3)));\n",
     "    const int rest = warp_max(k0);\n"),
)
TILES = "constexpr int kMaxTiles = 16;"
UNROLL = "constexpr int kUnroll = 4;"
THREADS = "constexpr int kThreads = 128;"
# source -> {variant: swaps}; a swap is (old, new), old found at least once
VARIANTS = {
    "gather_rows": {
        "as_built": (),
        "u1": ((UNROLL, "constexpr int kUnroll = 1;"),),
        "u2": ((UNROLL, "constexpr int kUnroll = 2;"),),
        "u8": ((UNROLL, "constexpr int kUnroll = 8;"),),
        "t64": ((THREADS, "constexpr int kThreads = 64;"),),
        "t256": ((THREADS, "constexpr int kThreads = 256;"),),
        "t64_u2": ((THREADS, "constexpr int kThreads = 64;"),
                   (UNROLL, "constexpr int kUnroll = 2;")),
        "t64_u8": ((THREADS, "constexpr int kThreads = 64;"),
                   (UNROLL, "constexpr int kUnroll = 8;")),
        "t256_u2": ((THREADS, "constexpr int kThreads = 256;"),
                    (UNROLL, "constexpr int kUnroll = 2;")),
        "no_l1": asm_loads("ld.global.nc.L1::no_allocate"),
        "u2_no_l1": ((UNROLL, "constexpr int kUnroll = 2;"),
                     *asm_loads("ld.global.nc.L1::no_allocate")),
        "prefetch256": asm_loads("ld.global.nc.L2::256B"),
        "streaming_stores": (("    if (c < row_vecs) dst[c] = v[u];",
                              "    if (c < row_vecs) __stcs(dst + c, v[u]);"),),
    },
    "gather_rows_bulk": {
        "bulk_4x8k": (),
        "bulk_8x4k": (("constexpr int kStages = 4;",
                       "constexpr int kStages = 8;"),
                      ("constexpr int kChunkBytes = 8192;",
                       "constexpr int kChunkBytes = 4096;")),
        "bulk_2x16k": (("constexpr int kStages = 4;",
                        "constexpr int kStages = 2;"),
                       ("constexpr int kChunkBytes = 8192;",
                        "constexpr int kChunkBytes = 16384;")),
    },
    "extract_candidates": {
        "as_built": (),
        "shuffle": SHUFFLE,
        "direct": DIRECT,
        "shuffle_direct": SHUFFLE + DIRECT,
        "tiles4": ((TILES, "constexpr int kMaxTiles = 4;"),),
        "tiles8": ((TILES, "constexpr int kMaxTiles = 8;"),),
        "tiles32": ((TILES, "constexpr int kMaxTiles = 32;"),),
        "sorted": SORTED,
        "sorted_tiles8": SORTED + ((TILES, "constexpr int kMaxTiles = 8;"),),
        "sorted_tiles4": SORTED + ((TILES, "constexpr int kMaxTiles = 4;"),),
    },
}
KERNEL = {"gather_rows": "gather_rows", "gather_rows_bulk": "gather_rows",
          "extract_candidates": "extract_candidates"}


def _source_path(source: str, parent: str | None = None) -> str:
    from radad_tpu_torch.ops import _native

    if source == "gather_rows_bulk":
        return os.path.join(HERE, "gather_rows_bulk.cu")
    root = (os.path.join(parent, "radad_tpu_torch", "csrc") if parent
            else _native.CSRC_DIR)
    return os.path.join(root, f"{source}.cu")


def build_variants(parent: str | None) -> dict:
    """{kernel: {variant: loaded library}}, every variant built in
    parallel; prints each one's ptxas registers and spills."""
    import chip_smoke as cs
    from radad_tpu_torch.ops import _native

    out_dir = os.path.join(_native.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for source, variants in VARIANTS.items():
        src = open(_source_path(source)).read()
        for name, swaps in variants.items():
            text = src
            for old, new in swaps:
                if old not in text:
                    raise RuntimeError(f"{source}/{name}: '{old}' not found")
                text = text.replace(old, new)
            jobs.append((KERNEL[source], name, text))
    if parent:
        for kernel in ("gather_rows", "extract_candidates"):
            jobs.append((kernel, "parent",
                         open(_source_path(kernel, parent)).read()))
    procs = []
    for kernel, name, text in jobs:
        cu = os.path.join(out_dir, f"{kernel}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{kernel}_{name}.so")
        procs.append((kernel, name, lib, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for kernel, name, lib, proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            if name == "as_built":
                raise RuntimeError(f"{kernel}/{name}: nvcc failed\n{err}")
            print(f"{kernel}/{name}: nvcc failed, left out\n{err[-2000:]}")
            continue
        for fn, line in cs.ptxas_lines(out + err):
            if "registers" in line:
                print(f"ptxas[{kernel}/{name}] {fn}: {line}")
        if kernel == "gather_rows":
            print(f"SASS loads of gather_rows/{name}: {load_forms(lib)}")
        libs.setdefault(kernel, {})[name] = ctypes.CDLL(lib)
    return libs


def gather_calls(torch, libs, table, cold):
    """{variant: a call of its C entry on ``cold``'s next ids into a new
    output}."""
    from radad_tpu_torch.ops import _native

    n, d = table.shape
    calls = {}
    for name, lib in libs.items():
        fn = lib.radad_gather_rows
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def go(fn=fn, name=name, idx=None, out=None):
            idx = cold.next() if idx is None else idx
            out = cold.keep(torch.empty((idx.shape[0], d), device=table.device)
                            if out is None else out)
            rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                    d * 4, idx.shape[0], _native.stream_of(table))
            _native.check_launch(f"gather_rows/{name}", rc)
        calls[name] = go
    return calls


def load_forms(lib_path: str) -> list:
    """The global load opcodes (``LDG...``) in a built library's SASS, or
    [] where the toolkit has no ``cuobjdump``."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return []
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return sorted({w for line in sass.splitlines() for w in line.split()
                   if w.startswith("LDG")})


def extract_calls(torch, libs, cand, tsel, m, nt, outs):
    from radad_tpu_torch.ops import _native

    b, t, _ = cand.shape
    calls = {}
    for name, lib in libs.items():
        fn = lib.radad_extract_candidates
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def go(fn=fn, name=name):
            rc = fn(cand.data_ptr(), tsel.data_ptr(),
                    *(x.data_ptr() for x in outs), b, t, m, nt,
                    _native.stream_of(cand))
            _native.check_launch(f"extract_candidates/{name}", rc)
        calls[name] = go
    return calls


def time_all(torch, calls, library, kernel, iters):
    """{name: [ms, ms]}: every call's device time in order, then in reverse
    order; the library call once."""
    import chip_smoke as cs

    names = list(calls)
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(cs.device_ms(torch, calls[n], iters, name=kernel))
    ms["library"] = [cs.device_ms(torch, library, iters)]
    return ms


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        "runs", "select_gather_variants.txt"))
    ap.add_argument("--parent", default=None,
                    help="an unpacked earlier checkout to time beside")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from radad_tpu_torch.ops.gather import gather_rows_plain
    from radad_tpu_torch.ops.topk import extract_candidates_plain

    card, dev = cs.header(torch)
    libs = build_variants(args.parent)
    g = torch.Generator(device=dev).manual_seed(0)
    n, d = 25_600, 5_376
    table = torch.randn((n, d), generator=g, device=dev)
    lines = [f"card: {card}",
             f"profiler device ms per launch, {args.iters} launches a "
             f"reading; two readings a variant (in order, then reversed); "
             f"gathers read their rows from device memory"]
    faults = []

    def report(what, ms):
        line = f"{what}: " + ", ".join(
            f"{k} {sum(v) / len(v):.4f} {[round(x, 4) for x in v]}"
            for k, v in ms.items())
        print(line)
        lines.append(line)

    for m in (5, 32, 40, 256, 320, 1_280, 2_048):
        idx = torch.randint(-2, n + 2, (m,), generator=g, device=dev,
                            dtype=torch.int32)
        want = gather_rows_plain(table, idx)
        cold = cs.ColdRows(torch, n, m, m * d * 4, g)
        calls = gather_calls(torch, libs["gather_rows"], table, cold)
        for name, call in calls.items():
            out = torch.zeros_like(want)
            call(idx=idx, out=out)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                faults.append(f"gather_rows/{name} M={m} differs from plain")
        report(f"gather_rows M={m} (library: index_select)", time_all(
            torch, calls, lambda c=cold: c.keep(torch.index_select(
                table, 0, c.next(wide=True))), "gather_rows", args.iters))
    del table
    t, mm, nt = 24, 8, 200
    for b in (1, 8, 64, 256):
        cand = torch.randn((b, t, 128), generator=g, device=dev)
        cand[0, 0] = float("-inf")
        cand[b - 1, t - 1, 3] = cand[b - 1, t - 1, 64]
        cand[0, 2, :] = 0.5  # a whole tile tied
        cand[0, 3, 5:120] = float("-inf")  # fewer than m lanes left
        cand[0, 1, :] = -1.0 - torch.rand(128, generator=g, device=dev)
        cand[0, 1, 9], cand[0, 1, 40] = -0.0, 0.0
        tsel = torch.randint(0, nt, (b, t), generator=g, device=dev,
                             dtype=torch.int32)
        want = extract_candidates_plain(cand, tsel, mm, nt)
        outs = [torch.empty_like(x) for x in want]
        calls = extract_calls(torch, libs["extract_candidates"], cand, tsel,
                              mm, nt, outs)
        for name, call in calls.items():
            for x in outs:
                x.zero_()
            call()
            torch.cuda.synchronize()
            if not all(torch.equal(a, w) for a, w in zip(outs, want)):
                faults.append(f"extract_candidates/{name} B={b} differs from "
                              f"plain")
        report(f"extract_candidates B={b} (library: topk)", time_all(
            torch, calls, lambda c=cand: torch.topk(c, mm, dim=-1),
            "extract_candidates", args.iters))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines + faults) + "\n")
    if faults:
        raise AssertionError("; ".join(faults))
    return 0


if __name__ == "__main__":
    sys.exit(main())
