"""Plain forward passes of the two speech encoders, TPP and the clip
embedding, written from the published architectures.

- wav2vec2 base (facebook/wav2vec2-base-960h): 7 strided convolutions of
  512 channels (group norm over time on the first, GELU after each), LN and
  a linear projection to 768, a grouped positional convolution (128 taps,
  16 groups, one trailing frame dropped, GELU) added to it, the encoder LN,
  then 12 post-LN layers (12 heads, FFN 3,072, exact GELU). The features
  are the mean of the last four hidden states.
- Whisper base encoder (openai/whisper-base): each 2 s window zero-padded
  to 30 s, an 80-bin log-mel spectrogram (n_fft 400, hop 160, periodic
  Hann, reflect-centred, last frame dropped, slaney mel filters,
  log10 floored at max - 8, (x + 4) / 4), conv k3 s1 and conv k3 s2 with
  GELU, sinusoidal positions, 6 pre-LN layers (8 heads of 64, FFN 2,048; the
  key projection has no bias), the final LN. The features are the last
  hidden state.

A clip is cut into 2 s windows at a 1 s hop; each window's features are
pooled by TPP over levels (1, 2, 4) with max (bin i of n over T frames
covers [floor(i T / n), ceil((i + 1) T / n))), and the clip's embedding is
the mean over its windows.

Parameters come as a mapping of names to tensors (the names of the
harness's weight maker, ``harness/weights.py``). Every product goes through
``precision``: ``kind`` picks its rounding, so the same code is the
reference (``"exact"``, float32 with TF32 off) and its controls.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference import precision as P


def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.scale"],
                        p[f"{name}.bias"], eps)


def _attention(x, p, pre: str, heads: int, kind: str):
    b, t, d = x.shape
    hd = d // heads
    q = P.linear(x, p[f"{pre}.qw"], p[f"{pre}.qb"], kind) * hd ** -0.5
    k = P.linear(x, p[f"{pre}.kw"], p.get(f"{pre}.kb"), kind)
    v = P.linear(x, p[f"{pre}.vw"], p[f"{pre}.vb"], kind)

    def split(z):
        return z.reshape(b, t, heads, hd).transpose(1, 2)

    logits = P.matmul(split(q), split(k).transpose(-1, -2), kind)
    w = torch.softmax(logits, dim=-1)
    ctx = P.matmul(w, split(v), kind).transpose(1, 2).reshape(b, t, d)
    return P.linear(ctx, p[f"{pre}.ow"], p[f"{pre}.ob"], kind)


def _ffn(x, p, pre: str, kind: str):
    h = F.gelu(P.linear(x, p[f"{pre}.w1"], p[f"{pre}.b1"], kind))
    return P.linear(h, p[f"{pre}.w2"], p[f"{pre}.b2"], kind)


def wav2vec2_features(p: Mapping[str, torch.Tensor], arch: dict,
                      segments: torch.Tensor, *, normalize: bool,
                      layers_to_use: Sequence[int], kind: str = "exact"
                      ) -> torch.Tensor:
    """``segments [N, L]`` → features ``[N, T, D]`` (float32)."""
    if arch["feat_extract_norm"] != "group" or arch["do_stable_layer_norm"]:
        raise ValueError("the reference is written for the base models")
    eps = arch["layer_norm_eps"]
    x = segments.float()
    if normalize:  # zero mean, unit variance per window (eps 1e-7)
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        x = (x - mean) / torch.sqrt(var + 1e-7)
    x = x[:, None, :]
    for i, stride in enumerate(arch["conv_stride"]):
        x = P.conv1d(x, p[f"conv_layers.{i}.kernel"],
                     p.get(f"conv_layers.{i}.bias"), stride, 0, 1, kind)
        if i == 0:
            x = F.group_norm(x, x.shape[1], p["conv_layers.0.norm_scale"],
                             p["conv_layers.0.norm_bias"], 1e-5)
        x = F.gelu(x)
    x = x.transpose(1, 2)
    x = F.layer_norm(x, (x.shape[-1],), p["feat_proj.ln_scale"],
                     p["feat_proj.ln_bias"], eps)
    x = P.linear(x, p["feat_proj.kernel"], p["feat_proj.bias"], kind)
    k = arch["num_conv_pos_embeddings"]
    pos = P.conv1d(x.transpose(1, 2), p["pos_conv.kernel"],
                   p["pos_conv.bias"], 1, k // 2,
                   arch["num_conv_pos_embedding_groups"], kind)
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos.transpose(1, 2))
    x = _ln(x, p, "encoder_ln", eps)
    heads = arch["num_attention_heads"]
    hidden = [x]
    for i in range(arch["num_hidden_layers"]):
        pre = f"layers.{i}"
        x = _ln(x + _attention(x, p, f"{pre}.attn", heads, kind), p,
                f"{pre}.ln1", eps)
        x = _ln(x + _ffn(x, p, f"{pre}.ffn", kind), p, f"{pre}.ln2", eps)
        hidden.append(x)
    n = len(hidden)
    return torch.stack([hidden[i % n] for i in layers_to_use]).mean(0)


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


def whisper_features(p: Mapping[str, torch.Tensor], arch: dict,
                     segments: torch.Tensor, *, pad_seconds, kind: str =
                     "exact", mel_kind: str = "exact") -> torch.Tensor:
    """``segments [N, L]`` → features ``[N, T, D]`` (float32)."""
    x = segments.float()
    if pad_seconds is not None:
        target = int(pad_seconds * arch["sample_rate"])
        x = (F.pad(x, (0, target - x.shape[-1])) if x.shape[-1] < target
             else x[:, :target])
    x = log_mel(x, arch, mel_kind).transpose(1, 2)
    x = F.gelu(P.conv1d(x, p["conv1.kernel"], p["conv1.bias"], 1, 1, 1,
                        kind))
    x = F.gelu(P.conv1d(x, p["conv2.kernel"], p["conv2.bias"], 2, 1, 1,
                        kind)).transpose(1, 2)
    x = x + p["pos_embed"][: x.shape[1]]
    eps, heads = arch["layer_norm_eps"], arch["num_attention_heads"]
    for i in range(arch["num_hidden_layers"]):
        pre = f"layers.{i}"
        x = x + _attention(_ln(x, p, f"{pre}.ln1", eps), p, f"{pre}.attn",
                           heads, kind)
        x = x + _ffn(_ln(x, p, f"{pre}.ln2", eps), p, f"{pre}.ffn", kind)
    return _ln(x, p, "final_ln", eps)


def tpp(features: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Max pyramid pooling ``[..., T, D]`` → ``[..., sum(levels) D]``."""
    t = features.shape[-2]
    outs = []
    for level in levels:
        for i in range(level):
            lo, hi = math.floor(i * t / level), math.ceil((i + 1) * t / level)
            outs.append(features[..., lo:hi, :].amax(-2))
    return torch.cat(outs, -1)


def windows(audio: torch.Tensor, seg: int, hop: int) -> torch.Tensor:
    """``audio [B, N]`` → ``[B, S, seg]``, zero past the end."""
    n = audio.shape[-1]
    s = max(1, (n - seg) // hop + 1)
    if (s - 1) * hop + seg > n:
        audio = F.pad(audio, (0, (s - 1) * hop + seg - n))
    return torch.stack([audio[:, i * hop:i * hop + seg] for i in range(s)],
                       1)


def clip_embeddings(p, config: dict, audio: torch.Tensor, *,
                    kinds: Mapping[str, str] = None,
                    block: int = 16) -> torch.Tensor:
    """Clip embeddings ``[B, D_tpp]`` (float32) of ``audio [B, N]``, the
    encoder run ``block`` windows at a time. ``kinds``: the rounding of
    each stage ("encoder", "mel"), "exact" where absent."""
    kinds = dict(kinds or {})
    arch, pipe = config["architecture"], config["pipeline"]
    sr = pipe["sample_rate"]
    seg = int(pipe["segment_length"] * sr)
    hop = int(seg * (1 - pipe["segment_overlap"]))
    wins = windows(audio.float(), seg, hop)
    b, s = wins.shape[:2]
    flat = wins.reshape(b * s, seg)
    out = []
    for lo in range(0, flat.shape[0], block):
        part = flat[lo:lo + block]
        if config["encoder"] == "wav2vec2":
            feats = wav2vec2_features(
                p, arch, part, normalize=pipe["input_normalize"],
                layers_to_use=pipe["wav2vec2_layers_to_use"],
                kind=kinds.get("encoder", "exact"))
        else:
            feats = whisper_features(
                p, arch, part, pad_seconds=pipe["whisper_pad_seconds"],
                kind=kinds.get("encoder", "exact"),
                mel_kind=kinds.get("mel", "exact"))
        out.append(tpp(feats, pipe["tpp_levels"]))
    return torch.cat(out).reshape(b, s, -1).mean(1)
