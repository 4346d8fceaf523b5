"""Least time of the fused attention calls with WavLM's gated bias in the
traced slice over the device time of the bias body's kernels.

Each embed range of B clips holds one call a layer at (2 B windows, T, H,
HD), bias included; its least time is the larger of its operations at the
peak of the compute precision and its bytes at the HBM rate
(``flops/attention_bias.py``). The bias body's kernels are fused_mha's
``mha_*kernel`` instances whose bias template argument is true (only the
encoder's attention launches them; the slice holds whole calls). None
where none ran."""

import re

from flops import attention_bias, counts, peaks

# e.g. "void mha_bf16_resident_kernel<64, true, 7>(...)"
_BIAS_BODY = re.compile(r"(^|[\s:])mha_\w*kernel<[^>]*\btrue\b")


def read(run):
    s = run.trace_summary
    if s is None:
        return None
    spent = sum(k[2] for k in s.kernels if _BIAS_BODY.search(k[0])) * 1e-6
    if not spent:
        return None
    cfg = run.config
    least = 0.0
    for name, _, _ in s.ranges_named("embed:"):
        b, t, h, hd = counts.attention_shape(cfg, int(name.split(":")[1]))
        least += counts.layers(cfg) * attention_bias.least_s(
            b, t, h, hd, counts.dtype_bytes(cfg),
            peaks.FLOPS[cfg["compute_precision"]], peaks.HBM_BYTES_PER_S)
    return 100.0 * least / spent
