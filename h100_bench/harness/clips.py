"""Seeded synthetic clips, written as 16-bit mono WAV files.

Each clip is 3 s at 16 kHz: a sine at a frequency drawn from 120-600 Hz
with a random phase, plus, for the "spoof" class (two clips in three), its
fourth harmonic, plus a little white noise. The two classes differ in
spectrum, as the repository's synthetic test set does.
"""

from __future__ import annotations

import os
import wave
from typing import List, Tuple

import numpy as np


def write(directory: str, prefix: str, n: int, rng: np.random.Generator,
          sample_rate: int = 16_000, seconds: float = 3.0
          ) -> Tuple[List[str], List[float]]:
    """``n`` clips named ``<prefix>_<i>.wav`` → (paths, labels)."""
    t = np.arange(int(sample_rate * seconds)) / sample_rate
    spoof = (np.arange(n) % 3) != 0
    freq = rng.uniform(120.0, 600.0, (n, 1))
    phase = rng.uniform(0.0, 6.28, (n, 1))
    waves = 0.4 * np.sin(2 * np.pi * freq * t + phase)
    waves += spoof[:, None] * 0.3 * np.sin(2 * np.pi * 4 * freq * t)
    waves += 0.02 * rng.standard_normal(waves.shape)
    pcm = (np.clip(waves, -1.0, 1.0) * 32767.0).astype("<i2")
    paths = []
    for i in range(n):
        path = os.path.join(directory, f"{prefix}_{i:04d}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm[i].tobytes())
        paths.append(path)
    return paths, [1.0 if s else 0.0 for s in spoof]
