"""Host-side audio decode: WAV → float32 mono @ target sample rate.

Counterpart: ``radad_tpu/data/audio.py``. Decoding is:

  1. the native C++ decoder (``radad_tpu_torch/native``, built at first use
     by the host g++ and loaded with ctypes) where it builds and loads;
  2. a pure-Python WAV parser (stdlib ``wave`` + numpy) otherwise, with
     ``scipy.io.wavfile`` for IEEE-float WAVs;
  3. for non-WAV formats, an ``ffmpeg`` CLI pipe when ffmpeg is on PATH;
  4. zero-fill on any failure, matching the reference loader
     (dataset.py:151-153).

Resampling is polyphase (``scipy.signal.resample_poly``).

``load_audio_batch`` fills the rows of one caller-given batch array with
exactly what ``load_audio`` returns a clip, on a pool of host threads; a
clip at the target rate goes from the native decoder straight into its
row. ``decode_counts`` counts how often it runs on the pool.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import wave
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_native = None  # the loaded C++ decoder, False where it cannot load


def _try_load_native():
    """The native decoder, or False where it does not build or load (no
    toolchain): the pure-Python parser is then used."""
    global _native
    if _native is not None:
        return _native
    try:
        from radad_tpu_torch.native import load

        _native = load()
    except Exception as e:  # no g++, failed build: pure-Python decoder
        logger.info("native audio decoder unavailable (%s); using the "
                    "Python WAV parser", e)
        _native = False
    return _native


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


def _via_ffmpeg(path: str) -> bool:
    """Whether ``load_audio`` decodes ``path`` through ffmpeg (another
    extension than a WAV's, with ffmpeg installed); any other file goes to
    the native decoder, else to the Python parser."""
    return (os.path.splitext(path)[1].lower() not in _WAV_EXTS
            and have_ffmpeg())


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
        if _via_ffmpeg(path):
            audio, sr = _decode_ffmpeg(path, sample_rate, duration)
        else:
            native = _try_load_native()
            if native:
                audio, sr = native.decode(path)
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


# The batch decode's threads: one a CPU in this process's affinity mask, at
# most this many. The cap is not measured: the only host the decode was
# timed on has 8 CPUs, where the mask sets the size. On a host with more
# than 16 CPUs, time experiments/decode_stages.py --threads before trusting
# it.
_MAX_DECODE_THREADS = 16

_pool: Optional[ThreadPoolExecutor] = None
_workers = 0  # the pool's threads
_pool_lock = threading.Lock()


@dataclass
class DecodeCounts:
    """What ``load_audio_batch`` did: its calls, their rows (``clips``),
    the rows decoded off the calling thread (``pooled``), the pool's
    threads (``workers``; 0 until a call needs the pool) and the calls
    whose batch was page-locked (``pinned``)."""

    calls: int = 0
    clips: int = 0
    pooled: int = 0
    workers: int = 0
    pinned: int = 0


decode_counts = DecodeCounts()


def _decode_pool() -> ThreadPoolExecutor:
    """The batch decode's pool, made at first use."""
    global _pool, _workers
    with _pool_lock:
        if _pool is None:
            cpus = (len(os.sched_getaffinity(0))
                    if hasattr(os, "sched_getaffinity") else os.cpu_count())
            _workers = max(1, min(cpus or 1, _MAX_DECODE_THREADS))
            _pool = ThreadPoolExecutor(_workers,
                                       thread_name_prefix="radad-decode")
            # every thread started now: the executor starts one only where
            # it counts no idle one, and it counts a finished task as idle
            start = threading.Barrier(_workers)
            for f in [_pool.submit(start.wait) for _ in range(_workers)]:
                f.result()
        decode_counts.workers = _workers
        return _pool


def _decode_row(path: str, row: np.ndarray, native, sample_rate: int,
                duration: float) -> int:
    """``row`` := ``load_audio(path, pad=False)`` followed by zeros. → the
    decoded length. A WAV at ``sample_rate`` that ``load_audio`` would give
    the native decoder is decoded into the row itself; every other clip
    (another rate, another format, a failure) goes through ``load_audio``.

    The native call into the row is what makes the pool pay: on an 8-CPU
    H100 host, 64 clips took 5.3 ms a call on 8 threads this way against
    14.7 ms for ``load_audio`` a clip and a copy into its row
    (experiments/decode_stages.py)."""
    target_len = int(duration * sample_rate)
    if native and not _via_ffmpeg(path):
        try:
            n, sr = native.decode_into(path, row[:target_len])
        except Exception:  # load_audio below meets it again and logs it
            n, sr = -1, 0
        if n >= 0 and sr == sample_rate:
            n = min(n, target_len)
            row[n:] = 0.0
            return n
    audio = load_audio(path, sample_rate=sample_rate, duration=duration,
                       pad=False)
    row[:len(audio)] = audio
    row[len(audio):] = 0.0
    return len(audio)


def load_audio_batch(paths: Sequence[str], out, *, sample_rate: int = 16000,
                     duration: float = 3.0,
                     pad: bool = True) -> Optional[List[int]]:
    """Row ``r`` of ``out`` := ``load_audio(paths[r], sample_rate=...,
    duration=..., pad=...)``, zero past its end, bit for bit. ``out`` is a
    ``[len(paths), width]`` float32 array, or a host tensor (written
    through its ``numpy()`` view), ``width`` at least ``duration`` s of
    samples. → with ``pad=False`` each clip's decoded length, else None.

    A call of two clips or more decodes on the module's pool, a chunk of
    consecutive rows a thread, while the calling thread waits; a call of
    one, or on a single CPU, decodes on the calling thread."""
    pinned = False
    if not isinstance(out, np.ndarray):
        pinned = bool(out.is_pinned())
        out = out.numpy()
    rows, target_len = len(paths), int(duration * sample_rate)
    if (out.dtype != np.float32 or out.ndim != 2 or out.shape[0] != rows
            or out.shape[1] < target_len or out.strides[1] != 4):
        raise ValueError(f"load_audio_batch needs a float32 [{rows}, >= "
                         f"{target_len}] array, not {out.dtype} "
                         f"{list(out.shape)}")
    native = _try_load_native()
    lengths = [0] * rows

    def decode(lo: int, hi: int) -> None:
        for r in range(lo, hi):
            lengths[r] = _decode_row(paths[r], out[r], native, sample_rate,
                                     duration)

    pool = _decode_pool() if rows > 1 else None
    chunks = min(rows, _workers) if pool else 1
    if chunks > 1:
        cuts = [rows * i // chunks for i in range(chunks + 1)]
        for f in [pool.submit(decode, lo, hi)
                  for lo, hi in zip(cuts, cuts[1:])]:
            f.result()
    else:
        decode(0, rows)
    with _pool_lock:
        decode_counts.calls += 1
        decode_counts.clips += rows
        decode_counts.pooled += rows if chunks > 1 else 0
        decode_counts.pinned += pinned
    return None if pad else lengths


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
