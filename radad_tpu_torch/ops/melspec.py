"""Whisper's log-mel spectrogram, on the device.

Counterpart: ``radad_tpu/ops/melspec.py`` (``log_mel_spectrogram``,
``mel_filter_bank``), the on-device replacement of HF
``WhisperFeatureExtractor`` (reference feature_extractor.py:94-103):

  * STFT: n_fft = 400, hop = 160, periodic Hann, centred with reflect
    padding, last frame dropped → 3,000 frames for 30 s at 16 kHz;
  * mel filters: slaney-scale, slaney-normalized triangles over the 201
    rfft bins, 0–8,000 Hz (80 bins, or 128 for whisper-large-v3), built
    host-side in numpy (the same numbers as the JAX package's) and applied
    as one f32 product (TF32 off, as every f32 product of the port:
    ``utils/device.py::set_precision_flags``);
  * log10(max(power, 1e-10)), floored at the segment's max − 8 over both
    axes, then (x + 4) / 4.

The FFT is ``torch.fft.rfft`` (cuFFT on the card); the JAX package leaves
it to XLA (``jnp.fft.rfft``), outside any Pallas kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz * 3.0 / 200.0
    logstep = 27.0 / np.log(6.4)
    lin = freq * 3.0 / 200.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) * logstep,
                    lin)


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz * 3.0 / 200.0
    logstep = np.log(6.4) / 27.0
    lin = mels * 200.0 / 3.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    lin)


@functools.lru_cache(maxsize=8)
def mel_filter_bank(num_freq_bins: int = 201, num_mel: int = 80,
                    sample_rate: int = 16000, fmin: float = 0.0,
                    fmax: float = 8000.0) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filters [num_freq, num_mel]."""
    fft_freqs = np.linspace(0, sample_rate / 2, num_freq_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          num_mel + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # [M+2, F]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))  # [M, F]
    enorm = 2.0 / (hz_pts[2:num_mel + 2] - hz_pts[:num_mel])
    fb = fb * enorm[:, None]
    return fb.T.astype(np.float32)  # [F, M]


@functools.lru_cache(maxsize=8)
def _hann_window(n_fft: int) -> np.ndarray:
    # periodic Hann (torch.hann_window default)
    i = np.arange(n_fft)
    return (0.5 * (1.0 - np.cos(2.0 * math.pi * i / n_fft))).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _device_tables(device: torch.device, n_fft: int, num_mel: int,
                   sample_rate: int):
    """(Hann window [n_fft], mel filter bank [n_fft // 2 + 1, num_mel]) on
    ``device``, copied there once, not on every call (made outside
    inference mode, so that a later call with autograd on may read them)."""
    with torch.inference_mode(False):
        return (torch.as_tensor(_hann_window(n_fft), device=device),
                torch.as_tensor(mel_filter_bank(n_fft // 2 + 1, num_mel,
                                                sample_rate), device=device))


def log_mel_spectrogram(waveform: torch.Tensor, *, n_fft: int = 400,
                        hop: int = 160, num_mel: int = 80,
                        sample_rate: int = 16000) -> torch.Tensor:
    """``waveform [..., T]`` → log-mel features ``[..., T // hop, num_mel]``
    f32, with Whisper's normalization, on the waveform's device."""
    lead, n = waveform.shape[:-1], waveform.shape[-1]
    pad = n_fft // 2
    # reflect padding wants a channel axis: [N, 1, T]
    x = F.pad(waveform.reshape(-1, 1, n).float(), (pad, pad),
              mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # [N, T // hop + 1, n_fft], a view
    window, fb = _device_tables(x.device, n_fft, num_mel, sample_rate)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real.square() + spec.imag.square()  # [N, frames, F]
    power = power[:, :-1]  # drop the last frame (whisper convention)
    log_spec = torch.log10(torch.clamp(power @ fb, min=1e-10))
    # floor at the segment's max - 8 over time and mel bins
    gmax = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, gmax - 8.0)
    return ((log_spec + 4.0) / 4.0).reshape(lead + log_spec.shape[1:])
