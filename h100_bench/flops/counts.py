"""Operations and bytes of the model's work, from the published shapes.

A multiply-add counts as 2 operations. The encoders count their products
(convolutions, linear layers, the attention's two batched products, the
mel filter product), each in its encoder file's ``segment_flops``
(``encoders/<name>.py``); norms, activations, softmax and the FFT are left
out. The fusion model counts its linear layers and the weighted sum over
the neighbors.
"""

from __future__ import annotations

from harness.common import encoder


def windows_per_clip(config: dict) -> int:
    p = config["pipeline"]
    sr = p["sample_rate"]
    n, seg = int(p["clip_duration"] * sr), int(p["segment_length"] * sr)
    hop = int(seg * (1 - p["segment_overlap"]))
    return max(1, (n - seg) // hop + 1)


def encoder_flops(config: dict) -> float:
    """Operations of the encoder for one clip (all its windows)."""
    one = encoder(config).segment_flops(config["architecture"],
                                        config["pipeline"])
    return windows_per_clip(config) * one


def fusion_flops(config: dict) -> float:
    """Operations of the fusion model's forward for one query."""
    p = config["pipeline"]
    d = sum(p["tpp_levels"]) * encoder(config).width(config["architecture"])
    k, h, o = p["top_k"], p["projection_hidden_dim"], p["projection_output_dim"]
    flops = 2.0 * k * (d * h + h + d * h + h * d) + 2.0 * k * d
    flops += 2.0 * (d * h + h * o) + 2.0 * (d + o) * o
    dims = [o] + list(p["detection_hidden_dims"]) + [1]
    return flops + sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))


def clip_flops(config: dict) -> float:
    """Model operations of scoring one clip: encoder and fusion model."""
    return encoder_flops(config) + fusion_flops(config)


def attention_shape(config: dict, clips: int):
    """(sequences, frames, heads, head width) of one layer's attention
    for ``clips`` clips."""
    n, h, hd = encoder(config).attention(config["architecture"],
                                         config["pipeline"])
    return clips * windows_per_clip(config), n, h, hd


def attention_least_s(b: int, t: int, h: int, hd: int, elem_bytes: int,
                      peak_flops: float, peak_bytes: float) -> float:
    """Least time of one fused attention call: the larger of its
    4 b h t^2 hd operations at ``peak_flops`` and q, k, v read once plus
    the output written once at ``peak_bytes``."""
    ops = 4.0 * b * h * t * t * hd
    nbytes = 4.0 * b * t * h * hd * elem_bytes
    return max(ops / peak_flops, nbytes / peak_bytes)


def layers(config: dict) -> int:
    return config["architecture"]["num_hidden_layers"]


def dtype_bytes(config: dict) -> int:
    return 2 if config["pipeline"]["use_mixed_precision"] else 4

