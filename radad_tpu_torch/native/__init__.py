"""ctypes bindings for the native C++ audio decoder.

Counterpart: ``radad_tpu/native/__init__.py``, with its
``audio_decoder.cc`` copied beside this file. The library is built at first
use (``load``), not when this module is imported: the host ``g++`` with the
JAX package's Makefile flags compiles ``audio_decoder.cc`` into the
git-ignored ``radad_tpu_torch/build/libradad_audio.so``, and a library older
than its source is rebuilt. ``load`` raises where there is no toolchain or
the build fails, and ``radad_tpu_torch.data.audio`` then stays on its
pure-Python decoder, as the JAX package does. The C calls release the GIL,
so the thread-pool loader and ``load_audio_batch`` decode in parallel.

Run: ``from radad_tpu_torch.native import load; load().decode(path)``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "audio_decoder.cc")
LIBRARY = os.path.join(os.path.dirname(_DIR), "build", "libradad_audio.so")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_loaded = None


def _build() -> None:
    """Compile ``SOURCE`` into ``LIBRARY`` (a temporary file renamed into
    place, so concurrent processes never load a half-written library)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX) for the native "
                           "audio decoder")
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.tmp{os.getpid()}"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native audio decoder build failed:\n"
                           f"{proc.stderr}")
    os.replace(tmp, LIBRARY)


class AudioNative:
    """The loaded decoder library's three C calls."""

    def __init__(self, path: str = LIBRARY):
        lib = ctypes.CDLL(path)
        lib.radad_decode_fixed.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.c_int]
        lib.radad_decode_fixed.restype = ctypes.c_int
        lib.radad_decode_full.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int)]
        lib.radad_decode_full.restype = ctypes.c_long
        lib.radad_wav_duration.argtypes = [ctypes.c_char_p]
        lib.radad_wav_duration.restype = ctypes.c_double
        self.path = path
        self._lib = lib

    def decode(self, path: str):
        """Full decode at native rate → (float32 samples, sample_rate).
        Raises ValueError on failure so callers can fall back."""
        # First-try capacity from the file's byte size / 2: the mono sample
        # count is at most bytes / 2 for 16-bit+ PCM. 8-bit mono
        # undershoots, and the C call then returns the count needed and the
        # loop retries once.
        try:
            cap = max(4096, os.path.getsize(path) // 2 + 64)
        except OSError:
            cap = 1 << 22
        while True:
            out = np.empty(cap, np.float32)
            sr = ctypes.c_int(0)
            n = self._lib.radad_decode_full(
                path.encode(), out.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)), cap,
                ctypes.byref(sr))
            if n < 0:
                raise ValueError(f"native decode failed for {path}")
            if n <= cap:
                return out[:n].copy(), int(sr.value)
            cap = int(n)

    def decode_into(self, path: str, out: np.ndarray):
        """Decode at native rate into ``out`` (float32, contiguous): its
        first min(n, len(out)) samples. → (n, sample_rate), with n the
        clip's whole length, negative on failure."""
        sr = ctypes.c_int(0)
        n = self._lib.radad_decode_full(
            path.encode(), out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), out.shape[0],
            ctypes.byref(sr))
        return int(n), int(sr.value)

    def decode_fixed(self, path: str, target_len: int, target_sr: int):
        """Decode + resample + pad/truncate in one native call → float32
        [target_len]. Raises ValueError on failure."""
        out = np.empty(target_len, np.float32)
        rc = self._lib.radad_decode_fixed(
            path.encode(), out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            target_len, target_sr)
        if rc != 0:
            raise ValueError(f"native decode failed for {path}")
        return out

    def duration(self, path: str) -> float:
        d = self._lib.radad_wav_duration(path.encode())
        if d < 0:
            raise ValueError(f"native probe failed for {path}")
        return float(d)


def load() -> AudioNative:
    """The decoder, built first if its library is missing or older than
    ``audio_decoder.cc``."""
    global _loaded
    with _lock:
        if _loaded is None:
            if (not os.path.exists(LIBRARY) or os.path.getmtime(LIBRARY)
                    < os.path.getmtime(SOURCE)):
                _build()
            _loaded = AudioNative()
        return _loaded
