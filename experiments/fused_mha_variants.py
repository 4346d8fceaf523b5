#!/usr/bin/env python3
"""Device time of ``csrc/fused_mha.cu``'s two bodies and of variants of it,
on one GPU, at the WavLM serving shape (q, k, v [128, 99, 768] f32, 12
heads of 64; gate [128, 99, 12], pos_bias [12, 99, 99]).

Each variant is the committed source with a few lines replaced, built
by its own ``nvcc`` (the port's flags) into
``radad_tpu_torch/build/variants/`` and called through its C entry:

* ``as_built``: the source as it is (3xTF32; 8 warps = 128 query rows a
  block, so K and V are read once per (batch row, head), and at most 128
  registers, so 2 blocks an SM; Q in shared memory,
  split at each use; 32-key tiles; pos_bias read from L2 into registers
  before the tile's products;
  P V block sums added to O with round-to-nearest adds);
* ``tf32x1``: the two correction products dropped (hi.hi alone). Its time
  is the cost of the corrections; its error must lie outside the
  tolerance, or the script raises (the tolerance would not bite);
* ``rows64``: 4 warps = 64 query rows a block (4 blocks an SM);
* ``bias_staged``: pos_bias staged into shared memory with each key tile
  (4-byte ``cp.async``) instead of read directly;
* ``keys64``: 64-key tiles (a 32-register S tile);
* ``q_regs``: Q's fragments split once into registers (64 more a
  thread), 4 warps a block, registers capped for 3 blocks an SM;
* ``cvt_rna``: the TF32 rounding by the PTX ``cvt.rna.tf32.f32`` instead
  of two integer ops (the same values);
* ``bias_late``: pos_bias read after the tile's Q K^T products instead of
  before them (whether the compiler's scheduling hides its L2 latency);
* ``pv_chain``: P V accumulated in O's own tensor-core accumulator (no
  zero-accumulator block sums): faster, but the tensor core's truncating
  adds drift with T.

Every variant but ``tf32x1`` must stay within 1e-5 * (1 + |plain|) of
``mha_reference``. Times are CUDA-event means over back-to-back launches,
taken in turns (as_built, variant, variant, as_built), beside SDPA and the
plain version in the same call. Run from the root of a checkout:
``python3 experiments/fused_mha_variants.py [--out FILE]``; it prints a
table and writes it to ``FILE`` (default ``runs/fused_mha_variants.txt``).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

WARPS = "constexpr int kWarps = 8;"
# bias_staged: a [kRows][kKeys + 8] pos_bias tile joins each stage of the
# ring, filled by 4-byte cp.async beside K and V, read as float2 pairs
STAGED_SIZE = ("sizeof(float) * (2 * (kStageFloats<HD> + (BIAS ? kRows * kBS"
               " : 0)) + kRows * (HD + 4))")
BIAS_STAGED = (
    ("constexpr unsigned kFull = 0xffffffffu;\n",
     "constexpr unsigned kFull = 0xffffffffu;\n"
     "constexpr int kBS = kKeys + 8;  // padded stride of a staged bias row\n"),
    ("__device__ __forceinline__ void cp_async_commit()",
     "__device__ __forceinline__ void cp_async4(float* dst, const float* src,"
     " bool ok) {\n"
     "  asm volatile(\"cp.async.ca.shared.global [%0], [%1], 4, %2;\\n\" ::"
     "\"r\"(smem_u32(dst)), \"l\"(src),\n"
     "               \"r\"(ok ? 4 : 0));\n}\n\n"
     "__device__ __forceinline__ void cp_async_commit()"),
    ("  constexpr int kStage = kStageFloats<HD>;",
     "  constexpr int kStage = kStageFloats<HD> + (BIAS ? kRows * kBS : 0);"),
    ("      cp_async16(vs + r * KS + col, v + off, ok);\n    }\n",
     "      cp_async16(vs + r * KS + col, v + off, ok);\n    }\n"
     "    if constexpr (BIAS) {\n"
     "      float* bs = vs + kKeys * KS;  // [kRows][kBS]\n"
     "      const float* ph = pos + static_cast<int64_t>(h) * t_len * t_len;\n"
     "      for (int i = tid; i < kRows * kKeys; i += kThreads) {\n"
     "        const int r = i / kKeys, col = i % kKeys;\n"
     "        const bool ok = t0 + r < t_len && s0 + col < t_len;\n"
     "        cp_async4(bs + r * kBS + col,\n"
     "                  ok ? ph + static_cast<int64_t>(t0 + r) * t_len"
     " + s0 + col : pos, ok);\n"
     "      }\n    }\n"),
    ("        const int key = s0 + 8 * f + 2 * c;\n"
     "        const float2 zero = make_float2(0.f, 0.f);\n"
     "        pb_lo[f] = f < nkf && t_lo < t_len ? bias_pair(pos_lo, key,"
     " t_len, pair) : zero;\n"
     "        pb_hi[f] = f < nkf && t_hi < t_len ? bias_pair(pos_hi, key,"
     " t_len, pair) : zero;\n",
     "        const float* bs = vs + kKeys * KS + (r0 + g) * kBS + 8 * f"
     " + 2 * c;\n"
     "        pb_lo[f] = *reinterpret_cast<const float2*>(bs);\n"
     "        pb_hi[f] = *reinterpret_cast<const float2*>(bs + 8 * kBS);\n"),
    ("  constexpr size_t smem = smem_bytes<HD>();",
     f"  constexpr size_t smem = {STAGED_SIZE};"),
)
# q_regs: Q's A fragments split once into registers (HD <= 64), 4 warps a
# block, registers capped for 3 blocks an SM
Q_REGS = (
    ("  const float* qw = qs + (r0 + g) * KS + c;  // the lane's A-fragment"
     " origin\n",
     "  const float* qw = qs + (r0 + g) * KS + c;  // the lane's A-fragment"
     " origin\n"
     "  constexpr int QR = HD <= 64 ? KSTEPS : 1;\n"
     "  uint32_t qh[QR][4], ql[QR][4];\n"
     "  if constexpr (HD <= 64) {\n#pragma unroll\n"
     "    for (int kk = 0; kk < KSTEPS; ++kk) load_a(qw + 8 * kk, KS,"
     " qh[kk], ql[kk]);\n  }\n"),
    ("      load_a(qw + 8 * kk, KS, ah, al);\n",
     "      if constexpr (HD <= 64) {\n#pragma unroll\n"
     "        for (int e = 0; e < 4; ++e) {\n"
     "          ah[e] = qh[kk % QR][e];\n          al[e] = ql[kk % QR][e];\n"
     "        }\n      } else {\n"
     "        load_a(qw + 8 * kk, KS, ah, al);\n      }\n"),
    (WARPS, "constexpr int kWarps = 4;"),
    ("constexpr int kMinBlocks = 16 / kWarps;",
     "constexpr int kMinBlocks = 12 / kWarps;"),
)
VARIANTS = {  # name -> (old text, new text) swaps
    "as_built": (),
    "tf32x1": (("  mma_tf32(d, al, bh[0], bh[1]);\n"
                "  mma_tf32(d, ah, bl[0], bl[1]);\n", ""),),
    "rows64": ((WARPS, "constexpr int kWarps = 4;"),),
    "bias_staged": BIAS_STAGED,
    "keys64": (("constexpr int kKeys = 32;", "constexpr int kKeys = 64;"),),
    "q_regs": Q_REGS,
    "cvt_rna": (("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) "
                 ": \"f\"(x));\n  return r;"),),
    "bias_late": None,  # swaps made from the source: _bias_late
    "pv_chain": (("          float blk[4] = {0.f, 0.f, 0.f, 0.f};\n"
                  "          mma3(blk, ph, pl, bh, bl);\n"
                  "          add4(o[nd], blk);\n",
                  "          mma3(o[nd], ph, pl, bh, bl);\n"),),
}


def _bias_late(src: str):
    """Swaps that move the block reading a tile's pos_bias from before the
    Q K^T products to after them."""
    start = src.index("    // the tile's pos_bias pairs")
    block = src[start:src.index("    // S = Q K^T")]
    after = "    // the gated bias"
    return (block, ""), (after, block + after)


def build_variants() -> dict:
    """name -> loaded library of every variant, built in parallel."""
    from radad_tpu_torch.ops import _native

    src = open(os.path.join(_native.CSRC_DIR, "fused_mha.cu")).read()
    out_dir = os.path.join(_native.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, swap in VARIANTS.items():
        text = src
        for old, new in swap or _bias_late(src):
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: '{old}' not found once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"fused_mha_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libfused_mha_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        report = (out + err).splitlines()
        for i, line in enumerate(report):  # the HD = 64 instances
            for body, tag in (("no bias", "mha_kernelILi64ELb0E"),
                              ("bias", "mha_kernelILi64ELb1E")):
                if tag in line and "Function properties" in line:
                    print(f"ptxas[{name}, {body}]: " + " | ".join(
                        x.strip() for x in report[i + 1: i + 3]))
        libs[name] = ctypes.CDLL(lib)
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        "runs", "fused_mha_variants.txt"))
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from radad_tpu_torch.ops import _native
    from radad_tpu_torch.ops.attention import mha_reference

    card, dev = cs.header(torch)
    libs = build_variants()
    b, t, d, h = 128, 99, 768, 12
    hd = d // h
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, t, d), generator=g, device=dev)
               for _ in range(3))
    q *= hd ** -0.5
    gate = 1.0 + 2.0 * torch.rand((b, t, h), generator=g, device=dev)
    pos = torch.randn((h, t, t), generator=g, device=dev)
    out = torch.empty_like(q)
    lines = [f"card: {card}",
             f"q,k,v [{b},{t},{d}] f32, {h} heads; CUDA-event ms per "
             f"launch, {args.iters} launches; err = max |kernel - plain| / "
             f"(1 + |plain|), tolerance 1e-5"]

    def call(lib, bias):
        fn = lib.radad_fused_mha
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def go():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    gate.data_ptr() if bias else None,
                    pos.data_ptr() if bias else None, out.data_ptr(), b, t,
                    d, h, _native.stream_of(q))
            _native.check_launch("fused_mha variant", rc)
        return go

    def split(x):
        return x.view(b, t, h, hd).transpose(1, 2)

    mask = gate.transpose(1, 2)[..., None] * pos[None]
    faults = []
    for bias in (False, True):
        extra = dict(gate=gate, pos_bias=pos) if bias else {}
        want = mha_reference(q, k, v, h, **extra)
        errs = {}
        for name, lib in libs.items():
            call(lib, bias)()
            torch.cuda.synchronize()
            errs[name] = float(((out - want).abs()
                                / (1 + want.abs())).max())
            inside = errs[name] <= 1e-5
            if inside != (name != "tf32x1"):
                faults.append(
                    f"{name} {'bias' if bias else 'no bias'}: err "
                    f"{errs[name]:.3e} {'inside' if inside else 'outside'} "
                    f"the 1e-5 tolerance")
        base = call(libs["as_built"], bias)
        row = {}
        for name, lib in libs.items():
            if name == "as_built":
                continue
            var = call(lib, bias)
            ts = [cs.time_ms(torch, f, iters=args.iters)
                  for f in (base, var, var, base)]
            row["as_built"] = row.get("as_built", []) + [ts[0], ts[3]]
            row[name] = [ts[1], ts[2]]
        qh, kh, vh = split(q), split(k), split(v)
        sdpa = (lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask if bias else None, scale=1.0))
        row["sdpa"] = [cs.time_ms(torch, sdpa, iters=args.iters)]
        row["plain"] = [cs.time_ms(
            torch, lambda: mha_reference(q, k, v, h, **extra),
            iters=args.iters)]
        line = (f"{'bias' if bias else 'no bias'}: " + ", ".join(
            f"{n} {sum(x) / len(x):.4f} ms {[round(y, 4) for y in x]}"
            + (f" err {errs[n]:.3e}" if n in errs else "")
            for n, x in row.items()))
        print(line)
        lines.append(line)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines + faults) + "\n")
    if faults:
        raise AssertionError("; ".join(faults))
    return 0


if __name__ == "__main__":
    sys.exit(main())
