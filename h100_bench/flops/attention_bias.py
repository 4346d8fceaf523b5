"""Operations and bytes of one call of the fused attention with WavLM's
gated relative position bias (``fused_mha``'s bias body).

Over ``b`` sequences of ``t`` frames, ``h`` heads of width ``hd``: the two
products, 4 b h t^2 hd operations, and the gated add ``gate · pos`` of the
logits, 2 b h t^2 (a multiply and an add a logit). Bytes: q, k, v read
once and the output written once (4 b t h hd elements), ``gate [b, t, h]``
and ``pos_bias [h, t, t]`` read once.
"""

from __future__ import annotations


def ops(b: int, t: int, h: int, hd: int) -> float:
    return 4.0 * b * h * t * t * hd + 2.0 * b * h * t * t


def nbytes(b: int, t: int, h: int, hd: int, elem_bytes: int) -> float:
    return (4.0 * b * t * h * hd + b * t * h + h * t * t) * elem_bytes


def least_s(b: int, t: int, h: int, hd: int, elem_bytes: int,
            peak_flops: float, peak_bytes: float) -> float:
    """The larger of the operations at ``peak_flops`` and the bytes at
    ``peak_bytes``."""
    return max(ops(b, t, h, hd) / peak_flops,
               nbytes(b, t, h, hd, elem_bytes) / peak_bytes)
