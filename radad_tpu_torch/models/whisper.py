"""Whisper encoder as a frozen PyTorch module, with the on-device log-mel
frontend.

Counterpart: ``radad_tpu/models/whisper.py`` (the architecture of HF
``WhisperModel.encoder`` behind ``WhisperFeatureExtractor``, reference
feature_extractor.py:54-115). Each segment is zero-padded (or cut) to 30 s,
turned into an 80-bin log-mel spectrogram (``ops/melspec.py``) and run
through conv1 (k3, s1, p1) → GELU → conv2 (k3, s2, p1) → GELU → + the
sinusoidal positions → N pre-LN layers (``encoder_common.pre_ln_layer``;
k_proj has no bias) → the final LayerNorm. The features are the last
hidden state, ``d_model`` wide per frame.

``pad_to_seconds=30`` is the reference's semantics: a 2 s window becomes
3,000 mel frames and 1,500 encoder frames, mostly padding, and TPP pools
over all of them. ``pad_to_seconds=None`` (``--whisper_fast``) runs only
the real frames (200 mel frames, 100 encoder frames for 2 s) with the
positions sliced: other embeddings, about 15× fewer FLOPs; opt-in.

Parameters keep the JAX pytree's names (``conv1``, ``conv2``,
``pos_embed``, ``final_ln``, ``layers[i].attn.qw`` ...) in PyTorch layouts:
conv kernels ``[C_out, C_in, K]``, linear weights ``[out, in]``. The JAX
package keeps its activations channels-last with kernels
``[K, C_in, C_out]``; the converters transpose.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radad_tpu_torch.models import encoder_common as C
from radad_tpu_torch.models.wav2vec2 import _ln, _param
from radad_tpu_torch.ops.melspec import log_mel_spectrogram


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Defaults = openai/whisper-base's encoder."""

    d_model: int = 512
    num_hidden_layers: int = 6
    num_attention_heads: int = 8
    ffn_dim: int = 2048
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    layer_norm_eps: float = 1e-5

    @property
    def feature_dim(self) -> int:
        return self.d_model

    def frames_for_samples(self, n_samples: int,
                           pad_to_seconds: Optional[float] = 30.0) -> int:
        """Encoder frames of a segment of ``n_samples`` (of the padded
        30 s unless ``pad_to_seconds`` is None)."""
        if pad_to_seconds is not None:
            n_samples = int(pad_to_seconds * self.sample_rate)
        mel_frames = n_samples // self.hop_length
        return C.conv_output_length(mel_frames, 3, 2, padding=1)


class WhisperEncoder(nn.Module):
    """Frozen parameters of one Whisper encoder (zeros until initialized by
    ``init_params`` or filled by a converter)."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.ffn_dim
        self.conv1 = nn.ParameterDict({
            "kernel": _param(d, cfg.num_mel_bins, 3), "bias": _param(d)})
        self.conv2 = nn.ParameterDict({"kernel": _param(d, d, 3),
                                       "bias": _param(d)})
        self.pos_embed = _param(cfg.max_source_positions, d)
        self.final_ln = _ln(d)
        self.layers = nn.ModuleList(nn.ModuleDict({
            # no "kb": Whisper's k_proj has no bias
            "attn": nn.ParameterDict({
                name: _param(d, d) if name.endswith("w") else _param(d)
                for name in ("qw", "qb", "kw", "vw", "vb", "ow", "ob")}),
            "ln1": _ln(d),
            "ffn": nn.ParameterDict({"w1": _param(f, d), "b1": _param(f),
                                     "w2": _param(d, f), "b2": _param(d)}),
            "ln2": _ln(d),
        }) for _ in range(cfg.num_hidden_layers))


def encode_mel(model: WhisperEncoder, mel: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Log-mel ``[B, T_mel, n_mels]`` → the last hidden state
    ``[B, T_mel // 2, D]`` in ``dtype``: the mel is rounded to ``dtype``
    before conv1 and the positions are cast to it, as JAX's ``encode_mel``."""
    cfg = model.cfg
    x = mel.to(dtype).transpose(1, 2)  # the conv layout [B, n_mels, T]
    x = C.gelu(C.conv1d(x, model.conv1["kernel"], model.conv1["bias"],
                        stride=1, padding=1))
    x = C.gelu(C.conv1d(x, model.conv2["kernel"], model.conv2["bias"],
                        stride=2, padding=1))
    x = x.transpose(1, 2)
    x = x + model.pos_embed[:x.shape[1]].to(dtype)
    tp = getattr(model, "tp", None)  # parallel/tp.py's shard
    for layer in model.layers:
        x = C.pre_ln_layer(x, layer, cfg.num_attention_heads,
                           cfg.layer_norm_eps, tp=tp)
    ln = model.final_ln
    return C.layer_norm(x, ln["scale"], ln["bias"], cfg.layer_norm_eps)


def extract_features(model: WhisperEncoder, waveform: torch.Tensor,
                     pad_to_seconds: Optional[float] = 30.0,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Segments ``[B, T_samples]`` → encoder features ``[B, T_frames, D]``
    f32, computed in ``dtype``. With ``pad_to_seconds`` each segment is
    zero-padded (or cut) to that length before the mel transform, as HF
    pads the raw audio to 480,000 samples (feature_extractor.py:94-99)."""
    cfg = model.cfg
    if pad_to_seconds is not None:
        target = int(pad_to_seconds * cfg.sample_rate)
        cur = waveform.shape[-1]
        waveform = (F.pad(waveform, (0, target - cur)) if cur < target
                    else waveform[..., :target])
    mel = log_mel_spectrogram(waveform, n_fft=cfg.n_fft, hop=cfg.hop_length,
                              num_mel=cfg.num_mel_bins,
                              sample_rate=cfg.sample_rate)
    return encode_mel(model, mel, dtype).float()


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000) -> np.ndarray:
    """openai/whisper's positional table ``[length, channels]`` f32, the
    JAX package's numpy construction."""
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


@torch.no_grad()
def init_params(model: WhisperEncoder, generator: torch.Generator
                ) -> WhisperEncoder:
    """Seeded random init with the JAX package's scales: conv kernels
    uniform ±1/sqrt(K · C_in) with zero biases, linears (weights and
    biases) uniform ±1/sqrt(fan_in), LayerNorms at 1 and 0, and
    openai/whisper's sinusoid table (the numbers differ from JAX's, whose
    generator differs; the table is the same)."""
    def uniform_(p, fan_in):
        bound = 1.0 / fan_in ** 0.5
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                              generator=generator))

    cfg = model.cfg
    for conv in (model.conv1, model.conv2):
        _, cin, k = conv["kernel"].shape
        uniform_(conv["kernel"], k * cin)
    model.pos_embed.copy_(torch.as_tensor(
        sinusoids(cfg.max_source_positions, cfg.d_model)))
    for layer in model.layers:
        for p in layer["attn"].values():
            uniform_(p, cfg.d_model)
        ffn = layer["ffn"]
        uniform_(ffn["w1"], cfg.d_model)
        uniform_(ffn["b1"], cfg.d_model)
        uniform_(ffn["w2"], cfg.ffn_dim)
        uniform_(ffn["b2"], cfg.ffn_dim)
    return model
