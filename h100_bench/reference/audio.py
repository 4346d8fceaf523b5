"""Reading the benchmark's clips: mono 16-bit PCM WAV at the model's rate,
to float32 in [-1, 1), cut or zero-padded to the clip length."""

from __future__ import annotations

import wave

import numpy as np


def read_clip(path: str, samples: int, sample_rate: int) -> np.ndarray:
    with wave.open(path, "rb") as w:
        if (w.getnchannels(), w.getsampwidth(), w.getframerate()) != (
                1, 2, sample_rate):
            raise ValueError(f"{path}: not mono 16-bit PCM at {sample_rate}")
        raw = w.readframes(w.getnframes())
    x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    x = x[:samples]
    return np.pad(x, (0, samples - len(x)))
