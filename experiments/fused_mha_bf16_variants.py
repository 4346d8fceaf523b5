#!/usr/bin/env python3
"""Device time of ``csrc/fused_mha.cu``'s bf16 bodies and of variants of
them, on one GPU: the resident form's ``mma.sync`` kernel at the WavLM
serving shape (q, k, v [128, 99, 768] bf16, 12 heads of 64; gate
[128, 99, 12], pos_bias [12, 99, 99]) and at head width 80 ([16, 99,
1280], 16 heads); the resident form's ``wgmma`` kernel (head width 64
without bias) at [128, 99, 768] and at trimmed whisper-base's [16 | 128,
100, 512]; the streamed form at whisper-base's padded shapes ([16 | 128,
1500, 512], 8 heads of 64, bias-free).

Each variant is the committed source with a few lines replaced, built by
its own ``nvcc`` (the port's flags) into
``radad_tpu_torch/build/variants/`` and called through its C entry
``radad_fused_mha_bf16`` with the form it names. The resident form's
``mma.sync`` kernel (form 2: also at head width 64 without bias, where the
wrapper's form runs the ``wgmma`` kernel):

* ``as_built``: the kernel as it is (one pass at T <= 128: Q, K
  and V of a (batch row, head) in shared memory, S in registers, the exact
  row max and sum, ``ldmatrix`` fragments, ex2 and one reciprocal a row;
  grid (heads, row groups) sized to one wave, each block walking its batch
  rows with the next row's copies in flight, pos_bias staged once a block
  in ``ldmatrix`` rows; at most 128 registers, 2 blocks of 7 warps an SM;
  O stored from the accumulator fragments);
* ``streamed``: the same library's streamed form (taken above T = 128);
* ``rows1``: one (batch row, head) a block, one row buffer;
* ``regs255``: no register cap (one block an SM);
* ``warps8``: 8 warps a block at every T (at T = 99 one has no rows; the
  8-warp instance, one block an SM);
* ``scalar_reads``: Q, K fragments by 32-bit and V's by 16-bit shared
  reads instead of ``ldmatrix``;
* ``expf_div``: e = expf(s - m) and p = e / l;
* ``staged_store``: O staged in bf16 through the warp's own Q rows, then
  16-byte stores of whole rows.

The resident form's ``wgmma`` kernel (``RESIDENT_WGMMA_VARIANTS``, rows
``rw/...``):

* ``as_built``: TMA loads of a batch row's Q, K and V boxes into a ring of
  2 rows, one thread issuing, an mbarrier reporting the bytes; S and O by
  ``wgmma``; O staged in bf16 in the warpgroups' own Q rows and written by
  one thread's TMA stores after the block's barrier; the next row's K and
  V reloaded then, its Q after the following row's S;
* ``mma_sync``: the ``mma.sync`` kernel on the same inputs (form 2);
* ``store_wait``: each warpgroup stores its own rows by TMA and waits for
  the store to read them before the block's barrier, then Q, K and V are
  reloaded at once;
* ``direct_store``: O stored from the accumulator's registers by 4-byte
  stores to device memory (the kernel's first design), Q, K and V
  reloaded at once;
* ``l2_256``: the loads' L2 promotion at 256 bytes (a head's 128-byte row
  and its neighbour's).

Streamed form at head width 64 (``STREAMED_VARIANTS``):

* ``as_built``: the wgmma body (2 warpgroups of 64 rows a block, Q and K,
  V in 128B-swizzled shared memory, a 5-tile cp.async ring, P V retired
  each tile, 2 blocks an SM);
* ``mma_sync``: the mma.sync body that the other head widths take
  (FlashAttention-2 style, 4 warps of 32 rows, Q in registers);
* ``pv_in_flight``: P V left running into the next tile, retired after
  the next barrier (ptxas then serializes every wgmma: the loop's back
  edge copies O while it runs);
* ``stages4``: a 4-tile ring (2 tiles in flight);
* ``two_s``: ``experiments/fused_mha_wgmma_two_s.cuh`` in place of the
  body (S of the next tile issued before the softmax of this one, two S
  accumulators; one block an SM);
* ``parent`` (with ``--parent DIR``, an unpacked earlier checkout): that
  checkout's own streamed form, e.g. the two-pass body of PR 10.

Every variant must stay within ``BF16_TOL`` * (1 + |plain|) of
``fused_mha_plain`` (else the script raises). Times are CUDA-event means
over back-to-back launches, taken in turns (as_built, variant, variant,
as_built), beside SDPA on the same bf16 inputs (flash where bias-free) and
the plain version in the same call; one line times the resident
``as_built`` at B = 12 ... 128 (rows a block 1 ... 11). Run from the root
of a checkout:
``python3 experiments/fused_mha_bf16_variants.py [--out FILE] [--parent DIR]``;
it prints a table and writes it to ``FILE`` (default
``runs/fused_mha_bf16_variants.txt``).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the C entry's form codes: the resident form (at head width 64 without
# bias: its wgmma kernel), the streamed form, and the resident form's
# mma.sync kernel at every head width (the variants of that kernel below)
RESIDENT, STREAMED, RESIDENT_MMA = 1, 0, 2

# one (batch row, head) a block: a block never prefetches, one buffer
ROWS1 = (("constexpr int kResBuffers = 2;", "constexpr int kResBuffers = 1;"),
         ("  int64_t groups = (static_cast<int64_t>(sms) * per_sm + heads - 1)"
          " / heads;\n", "  int64_t groups = b;\n"))
# 8 warps at every T: the 8-warp instance
WARPS8 = (("  const int threads = 32 * ((t + 15) / 16);",
           "  const int threads = 32 * 8;"),
          ("  if (t <= 112)\n    return launch_resident_nk<HD, BIAS, 7>",
           "  if (false)\n    return launch_resident_nk<HD, BIAS, 7>"))
SCALAR_READS = (
    # the helper that packs two 16-bit reads (not in the source)
    ("__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], "
     "const bf16* p) {\n",
     "__device__ __forceinline__ uint32_t pair_u32(bf16 lo, bf16 hi) {\n"
     "  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);"
     "\n}\n\n"
     "__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], "
     "const bf16* p) {\n"),
    ("  ldsm_x4(a, q0 + (lane % 16) * RS + 16 * kk + 8 * (lane / 16));\n",
     "  const bf16* p = q0 + (lane / 4) * RS + 16 * kk + 2 * (lane % 4);\n"
     "  a[0] = *reinterpret_cast<const uint32_t*>(p);\n"
     "  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * RS);\n"
     "  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);\n"
     "  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * RS + 8);\n"),
    ("  ldsm_x4(b, kt + (16 * p + lane % 8 + 8 * (lane / 16)) * RS + 16 * kk"
     " + 8 * (lane / 8 % 2));\n",
     "  const bf16* r = kt + (16 * p + lane / 4) * RS + 16 * kk"
     " + 2 * (lane % 4);\n"
     "  b[0] = *reinterpret_cast<const uint32_t*>(r);\n"
     "  b[1] = *reinterpret_cast<const uint32_t*>(r + 8);\n"
     "  b[2] = *reinterpret_cast<const uint32_t*>(r + 8 * RS);\n"
     "  b[3] = *reinterpret_cast<const uint32_t*>(r + 8 * RS + 8);\n"),
    ("  ldsm_x4_trans(b, vt + (16 * kk + lane % 16) * RS + 16 * n"
     " + 8 * (lane / 16));\n",
     "  const bf16* r = vt + (16 * kk + 2 * (lane % 4)) * RS + 16 * n"
     " + lane / 4;\n"
     "  b[0] = pair_u32(r[0], r[RS]);\n"
     "  b[1] = pair_u32(r[8 * RS], r[9 * RS]);\n"
     "  b[2] = pair_u32(r[8], r[RS + 8]);\n"
     "  b[3] = pair_u32(r[8 * RS + 8], r[9 * RS + 8]);\n"),
)
EXPF_DIV = (
    ("float res_scale_max(float m) { return m * kLog2e; }",
     "float res_scale_max(float m) { return m; }"),
    ("float res_exp(float s, float ms) { return ex2(fmaf(s, kLog2e, -ms)); }",
     "float res_exp(float s, float ms) { return expf(s - ms); }"),
    ("float res_norm(float l) { return __frcp_rn(l); }",
     "float res_norm(float l) { return l; }"),
    ("float res_weight(float e, float n) { return e * n; }",
     "float res_weight(float e, float n) { return e / n; }"),
)
# O staged in bf16 through the warp's own Q rows (read only by this warp,
# in its Q K^T), then 16-byte stores of whole rows
STAGED_STORE = (
    ("          bf16* row = out + row_base(b) + static_cast<int64_t>(t_lo) * d_model"
     " + 16 * n + 2 * c;\n",
     "          bf16* row = const_cast<bf16*>(qw) + g * RS + 16 * n + 2 * c;\n"),
    ("          bf16* row = out + row_base(b) + static_cast<int64_t>(t_hi) * d_model"
     " + 16 * n + 2 * c;\n",
     "          bf16* row = const_cast<bf16*>(qw) + (g + 8) * RS + 16 * n + 2 * c;\n"),
    ("      }\n    }\n    // the next row's gate; its slot was last read before this"
     " row's barrier\n",
     """      }
      __syncwarp();
      bf16* orow = out + row_base(b);
#pragma unroll
      for (int j = lane; j < 16 * kCopies; j += 32) {
        const int r = j / kCopies, col = (j % kCopies) * 8;
        if (r0 + r < t_len)
          *reinterpret_cast<uint4*>(orow + static_cast<int64_t>(r0 + r) * d_model + col) =
              *reinterpret_cast<const uint4*>(qw + r * RS + col);
      }
    }
    // the next row's gate; its slot was last read before this row's barrier
"""),
)
# the streamed form at HD 64 (the wgmma kernel) -> (old text, new text) swaps
STREAMED_VARIANTS = {
    "as_built": (),
    "mma_sync": (("  if constexpr (HD == 64)\n    return launch_wgmma",
                  "  if constexpr (HD == -1)\n    return launch_wgmma"),),
    "pv_in_flight": (
        ("    fetch(j + kWgAhead);  // into the slot of tile j - 2\n"
         "    cp_async_commit();\n",
         "    fetch(j + kWgAhead);  // into the slot of tile j - 2\n"
         "    cp_async_commit();\n"
         "    wg_wait_all();\n"
         "    fence_regs(o);\n"),
        ("    wg_commit();\n"
         "    wg_wait_all();  // nothing in flight across the loop's back edge"
         " (see above)\n"
         "    fence_regs(o);\n"
         "  }\n",
         "    wg_commit();\n"
         "  }\n"
         "  wg_wait_all();\n"
         "  fence_regs(o);\n")),
    "stages4": (("constexpr int kWgStages = 5;", "constexpr int kWgStages = 4;"),),
    "two_s": "fused_mha_wgmma_two_s.cuh",  # the body's section replaced
}
VARIANTS = {  # name -> (form, (old text, new text) swaps)
    "as_built": (RESIDENT_MMA, ()),
    "streamed": (STREAMED, ()),  # the as_built library's streamed form
    "rows1": (RESIDENT_MMA, ROWS1),
    "regs255": (RESIDENT_MMA, (("constexpr int kResMinBlocks = 2;",
                                "constexpr int kResMinBlocks = 1;"),)),
    "warps8": (RESIDENT_MMA, WARPS8),
    "scalar_reads": (RESIDENT_MMA, SCALAR_READS),
    "expf_div": (RESIDENT_MMA, EXPF_DIV),
    "staged_store": (RESIDENT_MMA, STAGED_STORE),
}

# the resident form's wgmma kernel (head width 64, no bias): designs that
# lost, as swaps of the committed source
_DEFERRED_Q = ("    if (tid == 0 && i > 0 && b + stride < n_rows) {\n"
               "      tma_store_wait_read();\n"
               "      load(0, b + stride, slot ^ 1);\n"
               "    }\n", "")
_OWN_STORE = ("""    fence_async_smem();  // the writes before the stores' reads (async proxy)
    __syncthreads();     // ... everyone's; the slot's K and V are read
    if (tid == 0) {
      const bf16* qs = ring + slot * 3 * kRwTile;
      tma_store(&to, qs, 64 * h, 0, b);
      tma_store(&to, qs + 64 * 64, 64 * h, 64, b);
      if (b + kRwRing * stride < n_rows) {
        mbar_expect_tx(smem_u32(&full[slot]), bytes);
        load(1, b + kRwRing * stride, slot);
        load(2, b + kRwRing * stride, slot);
      }
    }
""", """    fence_async_smem();
    asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wg) : "memory");
    if (tid % 128 == 0) {
      tma_store(&to, qw, 64 * h, 64 * wg, b);
      tma_store_wait_read();
    }
    __syncthreads();
    if (tid == 0 && b + kRwRing * stride < n_rows) {
      mbar_expect_tx(smem_u32(&full[slot]), bytes);
      for (int j = 0; j < 3; ++j) load(j, b + kRwRing * stride, slot);
    }
""")


def _direct_store(src: str):
    """Swaps that store O from the accumulator's registers by 4-byte
    stores to global memory (rows < T), the kernel's first design, and
    reload a slot's Q, K and V at once after the block's barrier."""
    start = src.index("    // O in bf16 into the warpgroup's own Q rows")
    end = src.index('  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;')
    body = """    __syncthreads();
    if (tid == 0 && b + kRwRing * stride < n_rows) {
      mbar_expect_tx(smem_u32(&full[slot]), bytes);
      for (int j = 0; j < 3; ++j) load(j, b + kRwRing * stride, slot);
    }
    bf16* ob = out + static_cast<int64_t>(b) * t_len * d_model + 64 * h;
    const int t_lo = 16 * warp + g, t_hi = t_lo + 8;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int col = 8 * f + 2 * c;
      if (t_lo < t_len)
        *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(t_lo) * d_model + col) =
            pack_bf16(o[4 * f], o[4 * f + 1]);
      if (t_hi < t_len)
        *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(t_hi) * d_model + col) =
            pack_bf16(o[4 * f + 2], o[4 * f + 3]);
    }
  }
"""
    swaps = [_DEFERRED_Q, (src[start:end], body),
             ("const __grid_constant__ CUtensorMap to, int n_rows, int t_len) {",
              "const __grid_constant__ CUtensorMap to, int n_rows, int t_len, "
              "bf16* out, int d_model) {"),
             ("int launch_resident_wgmma_n(const CUtensorMap (&maps)[4], "
              "int64_t b, int t, int heads,",
              "int launch_resident_wgmma_n(const CUtensorMap (&maps)[4], "
              "bf16* out, int d, int64_t b, int t, int heads,"),
             ("maps[0], maps[1], maps[2], maps[3], static_cast<int>(b), t);",
              "maps[0], maps[1], maps[2], maps[3], static_cast<int>(b), t, "
              "out, d);")]
    swaps += [(f"launch_resident_wgmma_n<{n}>(maps, b, t, heads, stream);",
               f"launch_resident_wgmma_n<{n}>(maps, out, d, b, t, heads, "
               f"stream);") for n in (64, 104, 128)]
    return tuple(swaps)


RESIDENT_WGMMA_VARIANTS = {  # name -> swaps, or a function of the source
    "store_wait": (_DEFERRED_Q, _OWN_STORE),
    "direct_store": _direct_store,
    "l2_256": (("CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                "CU_TENSOR_MAP_L2_PROMOTION_L2_256B"),),
}


def _build(jobs: dict) -> dict:
    """{name: (source text, ptxas tags to print)} -> {name: loaded library},
    one nvcc each, all started together; prints ptxas's registers and
    spills of the instances whose mangled names hold a tag."""
    from radad_tpu_torch.ops import _native

    out_dir = os.path.join(_native.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (text, _) in jobs.items():
        cu = os.path.join(out_dir, f"fused_mha_bf16_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libfused_mha_bf16_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        report = (out + err).splitlines()
        for i, line in enumerate(report):
            for tag in jobs[name][1]:
                if tag in line and "Function properties" in line:
                    print(f"ptxas[{name}, {tag}]: " + " | ".join(
                        x.strip() for x in report[i + 1: i + 3]))
                if tag in line and "Performance Loss" in line:
                    print(f"ptxas[{name}]: {line.strip()[:160]}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def _swapped(src: str, name: str, swaps) -> str:
    for old, new in swaps:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: '{old}' not found once")
        src = src.replace(old, new)
    return src


def build_variants(parent: str = "") -> dict:
    """name -> (form, loaded library) of every resident variant, and
    "streamed/<name>" of every streamed one (plus "streamed/parent" from
    ``parent``'s source), built in parallel."""
    from radad_tpu_torch.ops import _native

    src = open(os.path.join(_native.CSRC_DIR, "fused_mha.cu")).read()
    res_tags = [f"mha_bf16_resident_kernelILi{hd}ELb{flag}E"
                for hd in (64, 80) for flag in (0, 1)]
    jobs = {name: (_swapped(src, name, swaps), res_tags)
            for name, (form, swaps) in VARIANTS.items() if name != "streamed"}
    for name, swaps in STREAMED_VARIANTS.items():
        if isinstance(swaps, str):  # a file that replaces the wgmma section
            start = src.index("// ----------------------------------- bf16 "
                              "streamed body on wgmma")
            end = src.index("template <bool BIAS>\nint launch_wgmma(")
            body = open(os.path.join(os.path.dirname(
                os.path.abspath(__file__)), swaps)).read()
            swaps = ((src[start:end], body),)
        if name != "as_built":
            jobs[f"streamed_{name}"] = (
                _swapped(src, name, swaps),
                ["mha_bf16_wgmma_kernelILb0E",
                 "mha_bf16_streamed_kernelILi64ELb0E"])
    for name, swaps in RESIDENT_WGMMA_VARIANTS.items():
        if callable(swaps):
            swaps = swaps(src)
        jobs[f"rw_{name}"] = (_swapped(src, name, swaps),
                              ["mha_bf16_resident_wgmma_kernelILi104E"])
    if parent:
        jobs["streamed_parent"] = (open(os.path.join(
            parent, "radad_tpu_torch", "csrc", "fused_mha.cu")).read(), [])
    built = _build(jobs)
    libs = {name: (VARIANTS[name][0], built[name])
            for name in VARIANTS if name != "streamed"}
    libs["streamed"] = (STREAMED, libs["as_built"][1])
    libs["streamed/as_built"] = libs["streamed"]
    for name in jobs:
        if name.startswith("streamed_"):
            libs["streamed/" + name[len("streamed_"):]] = (STREAMED,
                                                           built[name])
    libs["rw/as_built"] = (RESIDENT, libs["as_built"][1])
    libs["rw/mma_sync"] = (RESIDENT_MMA, libs["as_built"][1])
    for name in RESIDENT_WGMMA_VARIANTS:
        libs[f"rw/{name}"] = (RESIDENT, built[f"rw_{name}"])
    return libs


def _caller(torch, native, tensors, b, t, d, h):
    """call(form, lib, bias, rows=b) -> a function that launches the C entry
    of ``lib`` on ``tensors`` (q, k, v, gate, pos, out)."""
    q, k, v, gate, pos, out = tensors

    def call(form, lib, bias, rows=b):
        fn = lib.radad_fused_mha_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def go():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    gate.data_ptr() if bias else None,
                    pos.data_ptr() if bias else None, out.data_ptr(),
                    rows, t, d, h, form, native.stream_of(q))
            native.check_launch("fused_mha bf16 variant", rc)
        return go
    return call


def main() -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        "runs", "fused_mha_bf16_variants.txt"))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--parent", default="",
                    help="an unpacked earlier checkout whose streamed form "
                         "is timed beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from radad_tpu_torch.ops import _native
    from radad_tpu_torch.ops.attention import BF16_TOL, fused_mha_plain

    card, dev = cs.header(torch)
    libs = build_variants(args.parent)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    lines = [f"card: {card}",
             f"CUDA-event ms per launch, {args.iters} launches; err = max "
             f"|kernel - plain| / (1 + |plain|), tolerance {BF16_TOL}"]
    faults = []

    def emit(line):
        print(line)
        lines.append(line)

    def inputs(b, t, d, h):
        hd = d // h
        q, k, v = (torch.randn((b, t, d), generator=g, device=dev)
                   for _ in range(3))
        q *= hd ** -0.5
        gate = 1.0 + 2.0 * torch.rand((b, t, h), generator=g, device=dev)
        pos = torch.randn((h, t, t), generator=g, device=dev)
        tensors = [x.to(bf) for x in (q, k, v, gate, pos)]
        return tensors + [torch.empty_like(tensors[0])]

    def compare(names, call, tensors, shape, bias, extra_rows):
        """err of every variant in ``names`` against the plain version,
        then each timed in turns beside the first; → {name: [ms, ...]}."""
        q, k, v, gate, pos, out = tensors
        b, t, d, h = shape
        extra = dict(gate=gate, pos_bias=pos) if bias else {}
        want = fused_mha_plain(q, k, v, h, **extra).float()
        errs = {}
        for name in names:
            call(*libs[name], bias)()
            torch.cuda.synchronize()
            errs[name] = float(((out.float() - want).abs()
                                / (1 + want.abs())).max())
            if not errs[name] <= BF16_TOL:
                faults.append(f"{name} [{b},{t},{d}] bias={bias}: err "
                              f"{errs[name]:.3e} outside {BF16_TOL}")
        base = call(*libs[names[0]], bias)
        row = {}
        for name in names[1:]:
            var = call(*libs[name], bias)
            ts = [cs.time_ms(torch, f, iters=args.iters)
                  for f in (base, var, var, base)]
            row[names[0]] = row.get(names[0], []) + [ts[0], ts[3]]
            row[name] = [ts[1], ts[2]]
        hd = d // h
        qh, kh, vh = (x.view(b, t, h, hd).transpose(1, 2) for x in (q, k, v))
        mask = (gate.float().transpose(1, 2)[..., None]
                * pos.float()[None]).to(bf) if bias else None
        row["sdpa"] = [cs.time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=1.0), iters=args.iters)]
        row["plain"] = [cs.time_ms(
            torch, lambda: fused_mha_plain(q, k, v, h, **extra), iters=20)]
        flop = 4.0 * b * h * t * t * hd
        emit(f"[{b},{t},{d}] {h} heads {'bias' if bias else 'no bias'}: "
             + ", ".join(
                 f"{n} {sum(x) / len(x):.4f} ms "
                 f"{[round(y, 4) for y in x]}"
                 + (f" ({flop / (sum(x) / len(x)) / 1e9:.0f} TFLOP/s)"
                    if extra_rows else "")
                 + (f" err {errs[n]:.3e}" if n in errs else "")
                 for n, x in row.items()))

    resident = [n for n in libs if "/" not in n]
    for shape in ((128, 99, 768, 12), (16, 99, 1280, 16)):
        tensors = inputs(*shape)
        call = _caller(torch, _native, tensors, *shape)
        for bias in (False, True):
            compare(resident, call, tensors, shape, bias, False)
            if shape[0] == 128:
                sweep = {rows: cs.time_ms(torch, call(*libs["as_built"], bias,
                                                      rows),
                                          iters=args.iters)
                         for rows in (12, 24, 48, 96, 128)}
                emit(f"  as_built by B ({'bias' if bias else 'no bias'}): "
                     + ", ".join(f"B={r} {ms:.4f} ms"
                                 for r, ms in sweep.items()))
        del tensors
    # the resident form at head width 64 without bias (its wgmma kernel):
    # the WavLM / wav2vec2 serving shape and trimmed whisper-base's
    wgmma_resident = [n for n in libs if n.startswith("rw/")]
    for shape in ((128, 99, 768, 12), (128, 100, 512, 8), (16, 100, 512, 8)):
        tensors = inputs(*shape)
        compare(wgmma_resident, _caller(torch, _native, tensors, *shape),
                tensors, shape, False, False)
        del tensors
    streamed = [n for n in libs if n.startswith("streamed/")]
    for shape in ((16, 1500, 512, 8), (128, 1500, 512, 8)):
        tensors = inputs(*shape)
        compare(streamed, _caller(torch, _native, tensors, *shape), tensors,
                shape, False, True)
        del tensors
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines + faults) + "\n")
    if faults:
        raise AssertionError("; ".join(faults))
    return 0


if __name__ == "__main__":
    sys.exit(main())
