"""Host-side audio decode: WAV → float32 mono @ target sample rate.

Counterpart: ``radad_tpu/data/audio.py``, copied without its native C++
decoder (``radad_tpu/native``, a later slice of the port). Decoding is:

  1. a pure-Python WAV parser (stdlib ``wave`` + numpy), with
     ``scipy.io.wavfile`` for IEEE-float WAVs;
  2. for non-WAV formats, an ``ffmpeg`` CLI pipe when ffmpeg is on PATH;
  3. zero-fill on any failure, matching the reference loader
     (dataset.py:151-153).

Resampling is polyphase (``scipy.signal.resample_poly``).
"""

from __future__ import annotations

import logging
import math
import os
import wave
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


def _decode_wav_python(path: str) -> tuple[np.ndarray, int]:
    """Decode a RIFF WAV file to float32 [-1, 1] (channels x frames collapsed)."""
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        sr = w.getframerate()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        # Could be int32 PCM or float32 (wave module reports both as width 4,
        # format tag is not exposed) — int32 PCM is the overwhelmingly common
        # case for .wav; float32 files are handled by the scipy fallback below.
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, sr


_WAV_EXTS = (".wav", ".wave")


_HAVE_FFMPEG: Optional[bool] = None


def have_ffmpeg() -> bool:
    global _HAVE_FFMPEG
    if _HAVE_FFMPEG is None:
        import shutil

        _HAVE_FFMPEG = shutil.which("ffmpeg") is not None
    return _HAVE_FFMPEG


def _decode_ffmpeg(path: str, sample_rate: int,
                   duration: Optional[float] = None
                   ) -> tuple[np.ndarray, int]:
    """Decode any ffmpeg-supported format (mp3/flac/ogg/m4a/webm…) to
    float32 mono at ``sample_rate`` via an ffmpeg pipe — the data-layer
    counterpart of the reference web app's transcode fallback
    (app.py:205-207); the reference's dataset loader reaches the same
    formats through librosa/audioread (dataset.py:143). ``duration``
    bounds the decode itself (``-t``), so a 3 s clip from an hour-long
    file does not transcode the whole hour."""
    import subprocess

    cmd = ["ffmpeg", "-v", "error"]
    if duration is not None:
        # small guard past the cut so truncate-after-decode stays exact
        cmd += ["-t", f"{duration + 0.05:.3f}"]
    cmd += ["-i", path, "-f", "f32le", "-ac", "1",
            "-ar", str(sample_rate), "pipe:1"]
    proc = subprocess.run(cmd, capture_output=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"ffmpeg decode failed: {proc.stderr.decode(errors='replace')[:200]}")
    return np.frombuffer(proc.stdout, dtype=np.float32).copy(), sample_rate


def _decode_scipy(path: str) -> tuple[np.ndarray, int]:
    """Fallback decoder via scipy.io.wavfile (handles IEEE-float WAVs)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        out = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        out = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        out = (data.astype(np.float32) - 128.0) / 128.0
    else:
        out = data.astype(np.float32)
    if out.ndim > 1:
        out = out.mean(axis=1)
    return out, sr


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return audio
    from scipy.signal import resample_poly

    g = math.gcd(sr, target_sr)
    return resample_poly(audio, target_sr // g, sr // g).astype(np.float32)


def load_audio(
    path: str,
    *,
    sample_rate: int = 16000,
    duration: Optional[float] = 3.0,
    pad: bool = True,
) -> np.ndarray:
    """Load audio as float32 mono at ``sample_rate``.

    Matches the reference loader's contract (dataset.py:139-153): truncate to
    ``duration`` seconds, zero-pad up to exactly that length, and return
    silence (zeros) on any decode failure rather than raising.
    With ``duration=None``, returns the full decoded clip (used when the 3 s
    truncation is lifted for long-file inference).
    """
    target_len = int(duration * sample_rate) if duration is not None else None
    try:
        if (os.path.splitext(path)[1].lower() not in _WAV_EXTS
                and have_ffmpeg()):
            audio, sr = _decode_ffmpeg(path, sample_rate, duration)
        else:
            try:
                audio, sr = _decode_wav_python(path)
            except Exception:
                audio, sr = _decode_scipy(path)
        if duration is not None:
            # Truncate *before* resampling to bound the filter cost, with a
            # small guard so polyphase edge effects don't shorten the clip.
            max_src = int(math.ceil(duration * sr)) + sr // 100
            audio = audio[:max_src]
        audio = resample(np.ascontiguousarray(audio, dtype=np.float32), sr, sample_rate)
        if target_len is not None:
            audio = audio[:target_len]
            if pad and len(audio) < target_len:
                audio = np.pad(audio, (0, target_len - len(audio)))
        return np.ascontiguousarray(audio, dtype=np.float32)
    except Exception as e:  # parity: unreadable audio → zeros, keep going
        logger.error("Error loading %s: %s", path, e)
        return np.zeros(target_len or sample_rate, dtype=np.float32)


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 16000) -> None:
    """Write mono float32 audio as 16-bit PCM WAV (used by tests/serving)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
