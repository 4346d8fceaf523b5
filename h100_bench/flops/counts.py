"""Operations and bytes of the model's work, from the published shapes.

A multiply-add counts as 2 operations. The encoders count their products
(convolutions, linear layers, the attention's two batched products, the
mel filter product); norms, activations, softmax and the FFT are left out.
The fusion model counts its linear layers and the weighted sum over the
neighbors.
"""

from __future__ import annotations


def conv_out(n: int, k: int, s: int, pad: int = 0) -> int:
    return (n + 2 * pad - k) // s + 1


def _layer(t: int, d: int, f: int) -> float:
    """One transformer layer over ``t`` frames: q, k, v, o; the FFN; the
    logits and the weighted sum."""
    return 2.0 * t * (4 * d * d + 2 * d * f) + 4.0 * t * t * d


def wav2vec2_segment(arch: dict, samples: int) -> float:
    flops, n, cin = 0.0, samples, 1
    for c, k, s in zip(arch["conv_dim"], arch["conv_kernel"],
                       arch["conv_stride"]):
        n = conv_out(n, k, s)
        flops += 2.0 * n * c * cin * k
        cin = c
    d, f = arch["hidden_size"], arch["intermediate_size"]
    g, kp = arch["num_conv_pos_embedding_groups"], arch["num_conv_pos_embeddings"]
    flops += 2.0 * n * cin * d  # feature projection
    flops += 2.0 * n * d * (d // g) * kp  # positional convolution
    return flops + arch["num_hidden_layers"] * _layer(n, d, f)


def whisper_frames(arch: dict, samples: int, pad_seconds) -> int:
    if pad_seconds is not None:
        samples = int(pad_seconds * arch["sample_rate"])
    return conv_out(samples // arch["hop_length"], 3, 2, 1)


def whisper_segment(arch: dict, samples: int, pad_seconds) -> float:
    if pad_seconds is not None:
        samples = int(pad_seconds * arch["sample_rate"])
    mel = samples // arch["hop_length"]
    d, m, f = arch["d_model"], arch["num_mel_bins"], arch["ffn_dim"]
    t = conv_out(mel, 3, 2, 1)
    flops = 2.0 * mel * (arch["n_fft"] // 2 + 1) * m  # mel filters
    flops += 2.0 * mel * d * m * 3 + 2.0 * t * d * d * 3  # conv1, conv2
    return flops + arch["num_hidden_layers"] * _layer(t, d, f)


def windows_per_clip(config: dict) -> int:
    p = config["pipeline"]
    sr = p["sample_rate"]
    n, seg = int(p["clip_duration"] * sr), int(p["segment_length"] * sr)
    hop = int(seg * (1 - p["segment_overlap"]))
    return max(1, (n - seg) // hop + 1)


def encoder_flops(config: dict) -> float:
    """Operations of the encoder for one clip (all its windows)."""
    p, arch = config["pipeline"], config["architecture"]
    seg = int(p["segment_length"] * p["sample_rate"])
    if config["encoder"] == "wav2vec2":
        one = wav2vec2_segment(arch, seg)
    else:
        one = whisper_segment(arch, seg, p["whisper_pad_seconds"])
    return windows_per_clip(config) * one


def fusion_flops(config: dict) -> float:
    """Operations of the fusion model's forward for one query."""
    p, arch = config["pipeline"], config["architecture"]
    d = sum(p["tpp_levels"]) * arch.get("hidden_size", arch.get("d_model"))
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
    p, arch = config["pipeline"], config["architecture"]
    seg = int(p["segment_length"] * p["sample_rate"])
    if config["encoder"] == "wav2vec2":
        n = seg
        for k, s in zip(arch["conv_kernel"], arch["conv_stride"]):
            n = conv_out(n, k, s)
        d, h = arch["hidden_size"], arch["num_attention_heads"]
    else:
        n = whisper_frames(arch, seg, p["whisper_pad_seconds"])
        d, h = arch["d_model"], arch["num_attention_heads"]
    return clips * windows_per_clip(config), n, h, d // h


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

