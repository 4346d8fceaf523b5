"""Least time of the fused attention calls in the traced slice over the
device time of the kernels fused_mha launched for them.

Each embed range of B clips holds one call a layer at (2 B windows, T, H,
HD); its least time is the larger of 4 B H T^2 HD operations at the peak
of the compute precision and q, k, v read once plus the output written
once at the HBM rate (flops/counts.py). Kernels are those named mha_*kernel (only the encoder's attention launches
them; the slice holds whole calls). None where no such kernel ran."""

import re

from flops import counts, peaks

# fused_mha's kernels: mha_kernel, mha_bf16_*_kernel (C++ names may carry a
# namespace and a return type before them)
_MHA = re.compile(r"(^|[\s:])mha_\w*kernel")


def read(run):
    s = run.trace_summary
    if s is None:
        return None
    cfg = run.config
    spent = sum(k[2] for k in s.kernels if _MHA.search(k[0])) * 1e-6
    least = 0.0
    for name, _, _ in s.ranges_named("embed:"):
        b, t, h, hd = counts.attention_shape(cfg, int(name.split(":")[1]))
        least += counts.layers(cfg) * counts.attention_least_s(
            b, t, h, hd, counts.dtype_bytes(cfg),
            peaks.FLOPS[cfg["compute_precision"]], peaks.HBM_BYTES_PER_S)
    return 100.0 * least / spent if spent else None
