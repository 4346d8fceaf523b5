"""Whisper base encoder (openai/whisper-base): each 2 s window zero-padded
to 30 s, an 80-bin log-mel spectrogram (n_fft 400, hop 160, periodic
Hann, reflect-centred, last frame dropped, slaney mel filters, log10
floored at max - 8, (x + 4) / 4), conv k3 s1 and conv k3 s2 with GELU,
sinusoidal positions, 6 pre-LN layers (8 heads of 64, FFN 2,048; the key
projection has no bias), the final LN. The features are the last hidden
state.

The encoder file of ``"encoder": "whisper"``: its weights, plain forward,
operations, attention shape, frame width, CPU cut and the port's classes,
as ``harness/common.py::encoder`` lists them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference import encoders as RE
from reference import precision as P

# the port's module of radad_tpu_torch.models, config class and model class
PORT = ("whisper", "WhisperConfig", "WhisperEncoder")

# 100 frames a window: the real frames only, not padded to 30 s
TINY = {"architecture": dict(d_model=32, num_hidden_layers=2,
                             num_attention_heads=4, ffn_dim=64),
        "pipeline": {"whisper_pad_seconds": None}}


def weights(arch: dict) -> RE.Spec:
    d, f, m = arch["d_model"], arch["ffn_dim"], arch["num_mel_bins"]
    spec: RE.Spec = [("conv1.kernel", (d, m, 3), 1 / math.sqrt(3 * m)),
                     ("conv1.bias", (d,), "zeros"),
                     ("conv2.kernel", (d, d, 3), 1 / math.sqrt(3 * d)),
                     ("conv2.bias", (d,), "zeros"),
                     ("pos_embed", (arch["max_source_positions"], d),
                      sinusoids(arch["max_source_positions"], d)),
                     ("final_ln.scale", (d,), "ones"),
                     ("final_ln.bias", (d,), "zeros")]
    for i in range(arch["num_hidden_layers"]):
        spec += RE.layer_spec(f"layers.{i}", d, f, key_bias=False)
    return spec


def _hz_to_mel(freq):
    freq = np.asarray(freq, np.float64)
    lin = freq * 3.0 / 200.0
    return np.where(freq >= 1000.0, 15.0 + np.log(np.maximum(freq, 1e-10)
                                                  / 1000.0) * 27.0
                    / np.log(6.4), lin)


def _mel_to_hz(mels):
    mels = np.asarray(mels, np.float64)
    return np.where(mels >= 15.0,
                    1000.0 * np.exp(np.log(6.4) / 27.0 * (mels - 15.0)),
                    mels * 200.0 / 3.0)


def mel_filters(n_freq: int, n_mel: int, sample_rate: int) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangles ``[n_freq, n_mel]`` over
    0 .. sample_rate / 2."""
    fft_freqs = np.linspace(0, sample_rate / 2, n_freq)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0),
                                n_mel + 2))
    ramps = hz[:, None] - fft_freqs[None, :]
    fdiff = np.diff(hz)
    fb = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                    ramps[2:] / fdiff[1:, None]))
    fb *= (2.0 / (hz[2:n_mel + 2] - hz[:n_mel]))[:, None]
    return fb.T.astype(np.float32)


def log_mel(wave: torch.Tensor, arch: dict, kind: str = "exact"
            ) -> torch.Tensor:
    """``wave [N, S]`` → ``[N, S // hop, n_mels]``."""
    n_fft, hop = arch["n_fft"], arch["hop_length"]
    x = F.pad(wave.float()[:, None], (n_fft // 2, n_fft // 2),
              mode="reflect")[:, 0]
    i = torch.arange(n_fft, device=wave.device, dtype=torch.float32)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / n_fft))
    spec = torch.fft.rfft(x.unfold(-1, n_fft, hop) * window, dim=-1)
    power = (spec.real.square() + spec.imag.square())[:, :-1]
    fb = torch.as_tensor(mel_filters(n_fft // 2 + 1, arch["num_mel_bins"],
                                     arch["sample_rate"]),
                         device=wave.device)
    logs = torch.log10(torch.clamp(P.matmul(power, fb, kind), min=1e-10))
    logs = torch.maximum(logs, logs.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """openai/whisper's positional table ``[length, channels]``."""
    inc = np.log(10000.0) / (channels // 2 - 1)
    t = np.arange(length)[:, None] * np.exp(-inc * np.arange(channels // 2))
    return torch.as_tensor(np.concatenate([np.sin(t), np.cos(t)], 1),
                           dtype=torch.float32)


def features(p, arch: dict, pipe: dict, segments: torch.Tensor,
             kinds) -> torch.Tensor:
    """``segments [N, L]`` → features ``[N, T, D]`` (float32)."""
    kind = kinds.get("encoder", "exact")
    pad_seconds = pipe["whisper_pad_seconds"]
    x = segments.float()
    if pad_seconds is not None:
        target = int(pad_seconds * arch["sample_rate"])
        x = (F.pad(x, (0, target - x.shape[-1])) if x.shape[-1] < target
             else x[:, :target])
    x = log_mel(x, arch, kinds.get("mel", "exact")).transpose(1, 2)
    x = F.gelu(P.conv1d(x, p["conv1.kernel"], p["conv1.bias"], 1, 1, 1,
                        kind))
    x = F.gelu(P.conv1d(x, p["conv2.kernel"], p["conv2.bias"], 2, 1, 1,
                        kind)).transpose(1, 2)
    x = x + p["pos_embed"][: x.shape[1]]
    eps, heads = arch["layer_norm_eps"], arch["num_attention_heads"]
    for i in range(arch["num_hidden_layers"]):
        pre = f"layers.{i}"
        x = x + RE.attention(RE.ln(x, p, f"{pre}.ln1", eps), p,
                             f"{pre}.attn", heads, kind)
        x = x + RE.ffn(RE.ln(x, p, f"{pre}.ln2", eps), p, f"{pre}.ffn", kind)
    return RE.ln(x, p, "final_ln", eps)


def _mel_frames(arch: dict, pipe: dict) -> int:
    samples = int(pipe["segment_length"] * pipe["sample_rate"])
    if pipe["whisper_pad_seconds"] is not None:
        samples = int(pipe["whisper_pad_seconds"] * arch["sample_rate"])
    return samples // arch["hop_length"]


def segment_flops(arch: dict, pipe: dict) -> float:
    mel = _mel_frames(arch, pipe)
    d, m, f = arch["d_model"], arch["num_mel_bins"], arch["ffn_dim"]
    t = RE.conv_out(mel, 3, 2, 1)
    flops = 2.0 * mel * (arch["n_fft"] // 2 + 1) * m  # mel filters
    flops += 2.0 * mel * d * m * 3 + 2.0 * t * d * d * 3  # conv1, conv2
    return flops + arch["num_hidden_layers"] * RE.layer_flops(t, d, f)


def attention(arch: dict, pipe: dict):
    h = arch["num_attention_heads"]
    return RE.conv_out(_mel_frames(arch, pipe), 3, 2, 1), h, \
        arch["d_model"] // h


def width(arch: dict) -> int:
    return arch["d_model"]
