"""The port's native C++ audio decoder (radad_tpu_torch/native) against the
JAX package's (radad_tpu/native) on tests/test_native_audio.py's cases:
equal samples, the same failures, load_audio's routing and its pure-Python
fallback without a toolchain, and a subprocess check that the port loads
its own library and nothing of radad_tpu."""

import os
import subprocess
import sys
import wave as wave_mod
import zlib

import numpy as np
import pytest

from radad_tpu.native import audio_native as jax_native
from radad_tpu_torch import native as tnative
from radad_tpu_torch.data import audio as taudio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    return tnative.load()


def _write(path, data, sr, sampwidth=2, channels=1):
    with wave_mod.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(sampwidth)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def _pcm16(x):
    return (np.clip(x, -1, 1) * 32767).astype("<i2")


def test_library_is_the_ports_own(native):
    assert native.path == tnative.LIBRARY
    assert os.path.dirname(tnative.LIBRARY) == os.path.join(
        REPO, "radad_tpu_torch", "build")
    assert os.path.exists(tnative.LIBRARY)


@pytest.mark.parametrize("case", ["mono16", "stereo16", "mono24", "mono8",
                                  "float32"])
def test_decode_equals_jax_decoder(native, tmp_path, case):
    """Full decode at the native rate: the JAX decoder's samples and rate,
    bit for bit, on the fast paths and the generic one; 16-bit mono also
    equals the pure-Python parser."""
    rng = np.random.default_rng(0)
    sig = 0.5 * np.sin(2 * np.pi * 440 * np.arange(16000) / 16000)
    path = str(tmp_path / f"{case}.wav")
    if case == "mono16":
        _write(path, _pcm16(sig), 16000)
    elif case == "stereo16":
        inter = np.stack([_pcm16(sig), _pcm16(rng.uniform(-1, 1, 16000))], 1)
        _write(path, inter, 8000, channels=2)
    elif case == "mono24":
        v = (np.clip(sig, -1, 1) * (2 ** 23 - 1)).astype(np.int32)
        b = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF],
                     1).astype(np.uint8)
        _write(path, b, 22050, sampwidth=3)
    elif case == "mono8":
        _write(path, ((sig + 1) * 127.5).astype(np.uint8), 11025,
               sampwidth=1)
    else:
        from scipy.io import wavfile

        wavfile.write(path, 16000, sig.astype(np.float32))
    got, sr = native.decode(path)
    want, want_sr = jax_native.decode(path)
    assert sr == want_sr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if case == "mono16":
        ref, _ = taudio._decode_wav_python(path)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sr_in,target_len", [(8000, 16000), (16000, 4000),
                                              (44100, 48000)])
def test_decode_fixed_equals_jax_decoder(native, tmp_path, sr_in,
                                         target_len):
    """Resample + pad / truncate in one call: the JAX decoder's samples;
    the 8 kHz tone stays a clean tone at 16 kHz."""
    t = np.arange(int(sr_in * 1.0)) / sr_in
    path = str(tmp_path / "r.wav")
    _write(path, _pcm16(0.5 * np.sin(2 * np.pi * 440.0 * t)), sr_in)
    out = native.decode_fixed(path, target_len, 16000)
    np.testing.assert_array_equal(out, jax_native.decode_fixed(
        path, target_len, 16000))
    assert out.shape == (target_len,)
    if sr_in == 8000:
        core = slice(200, 15800)
        expected = 0.5 * np.sin(2 * np.pi * 440.0 * np.arange(16000) / 16000)
        assert np.abs(out[core] - expected[core]).max() < 0.02
        assert np.all(out[16000:] == 0)


def test_duration_probe_and_failures(native, tmp_path):
    path = str(tmp_path / "d.wav")
    _write(path, _pcm16(np.zeros(24000)), 16000)
    assert native.duration(path) == jax_native.duration(path) == 1.5
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav at all")
    for call in (lambda: native.decode(bad),
                 lambda: native.duration(bad),
                 lambda: native.decode_fixed(str(tmp_path / "missing.wav"),
                                             100, 16000)):
        with pytest.raises(ValueError):
            call()


def test_malformed_inputs_agree_with_jax(native, tmp_path):
    """Truncated and byte-mutated WAVs: the port's decoder raises where the
    JAX decoder raises and otherwise returns its samples; load_audio maps
    every failure to zeros."""
    rng = np.random.default_rng(5)
    good = str(tmp_path / "good.wav")
    _write(good, _pcm16(0.25 * np.sin(np.arange(8000) / 7.0)), 16000)
    blob = open(good, "rb").read()
    cases = [blob[:cut] for cut in (1, 11, 12, 36, 44, 45, 100,
                                    len(blob) - 1)]
    for _ in range(60):
        b = bytearray(blob)
        b[int(rng.integers(0, 200))] = int(rng.integers(0, 256))
        cases.append(bytes(b))
    for pos, patch in ((40, b"\xff\xff\xff\x7f"), (22, b"\x00\x00"),
                       (24, b"\x00\x00\x00\x00"), (34, b"\x00\x00")):
        b = bytearray(blob)
        b[pos:pos + len(patch)] = patch
        cases.append(bytes(b))
    path = str(tmp_path / "fuzz.wav")
    for i, payload in enumerate(cases):
        with open(path, "wb") as f:
            f.write(payload)
        try:
            want = jax_native.decode(path)
        except ValueError:
            with pytest.raises(ValueError):
                native.decode(path)
        else:
            got = native.decode(path)
            assert got[1] == want[1], i
            np.testing.assert_array_equal(got[0], want[0])
        out = taudio.load_audio(path, sample_rate=16000, duration=0.5)
        assert out.shape == (8000,) and np.isfinite(out).all(), i


def test_load_audio_routes_through_native(tmp_path, monkeypatch):
    """load_audio decodes with the native library where it loads, and stays
    on the pure-Python parser, with the same samples, where it does not (no
    toolchain); non-WAV without ffmpeg gives zeros."""
    from radad_tpu.data.audio import load_audio as jax_load_audio

    path = str(tmp_path / "l.wav")
    _write(path, _pcm16(0.3 * np.sin(np.arange(40000) / 9.0)), 22050)
    monkeypatch.setattr(taudio, "_native", None)
    got = taudio.load_audio(path, sample_rate=16000, duration=3.0)
    assert taudio._native and isinstance(taudio._native, tnative.AudioNative)
    np.testing.assert_array_equal(got, jax_load_audio(
        path, sample_rate=16000, duration=3.0))

    def no_toolchain():
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(taudio, "_native", None)
    monkeypatch.setattr(tnative, "load", no_toolchain)
    fallback = taudio.load_audio(path, sample_rate=16000, duration=3.0)
    assert taudio._native is False
    np.testing.assert_allclose(fallback, got, atol=1e-6)
    monkeypatch.setattr(taudio, "have_ffmpeg", lambda: False)
    mp3 = tmp_path / "clip.mp3"
    mp3.write_bytes(b"\xff\xfbnot really an mp3")
    out = taudio.load_audio(str(mp3), sample_rate=16000, duration=1.0)
    assert out.shape == (16000,) and not out.any()


def test_subprocess_loads_no_radad_tpu_library(tmp_path):
    """A fresh interpreter that decodes through the port maps the port's
    libradad_audio.so and no file of radad_tpu (module or library)."""
    path = str(tmp_path / "s.wav")
    _write(path, _pcm16(np.ones(1600) * 0.5), 16000)
    code = (
        "import sys\n"
        "from radad_tpu_torch.data import audio\n"
        f"x = audio.load_audio({path!r}, duration=0.1)\n"
        "assert audio._native, 'native decoder not loaded'\n"
        "maps = open('/proc/self/maps').read()\n"
        "libs = sorted({l.split()[-1] for l in maps.splitlines()\n"
        "               if 'libradad_audio' in l})\n"
        "print(libs)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'radad_tpu')]\n"
        "assert not bad, bad\n"
        "assert abs(float(x[:1600].mean()) - 0.5) < 1e-3\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    libs = eval(proc.stdout.strip().splitlines()[-1])
    assert libs == [tnative.LIBRARY], libs
    assert not any(os.sep + "radad_tpu" + os.sep in lib for lib in libs)


def _clip(tmp_path, case):
    """One clip of ``case`` → its path (written as the case needs)."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    path = str(tmp_path / f"{case}.wav")
    sig = 0.4 * np.sin(np.arange(56000) / 11.0) + 0.05 * rng.standard_normal(
        56000)
    if case in ("mono16", "python_parser"):
        _write(path, _pcm16(sig[:48000]), 16000)
    elif case == "long":  # 3.5 s: truncated
        _write(path, _pcm16(sig), 16000)
    elif case == "short":  # 1.25 s: padded
        _write(path, _pcm16(sig[:20000]), 16000)
    elif case == "stereo16":
        _write(path, np.stack([_pcm16(sig[:48000]), _pcm16(-sig[:48000])],
                              1), 16000, channels=2)
    elif case == "mono24":
        v = (np.clip(sig[:48000], -1, 1) * (2 ** 23 - 1)).astype(np.int32)
        _write(path, np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF],
                              1).astype(np.uint8), 16000, sampwidth=3)
    elif case == "mono8":
        _write(path, ((np.clip(sig[:48000], -1, 1) + 1) * 127.5).astype(
            np.uint8), 16000, sampwidth=1)
    elif case == "float32":
        from scipy.io import wavfile

        wavfile.write(path, 16000, sig[:48000].astype(np.float32))
    elif case == "resampled":  # 8 kHz
        _write(path, _pcm16(sig[:24000]), 8000)
    elif case == "missing":
        path = str(tmp_path / "missing.wav")
    elif case == "corrupt":
        with open(path, "wb") as f:
            f.write(b"RIFF\x00\x00\x00\x00WAVEnot a chunk at all")
    elif case == "mp3_without_ffmpeg":
        path = str(tmp_path / "clip.mp3")
        with open(path, "wb") as f:
            f.write(b"\xff\xfbnot really an mp3")
    return path


BATCH_CASES = ["mono16", "long", "short", "stereo16", "mono24", "mono8",
               "float32", "resampled", "missing", "corrupt",
               "mp3_without_ffmpeg", "python_parser", "same_path_twice",
               "batch_of_1", "batch_of_64"]


@pytest.mark.parametrize("case", BATCH_CASES)
def test_load_audio_batch_equals_serial_load_audio(tmp_path, monkeypatch,
                                                   case):
    """Each row equals ``load_audio`` of its clip bit for bit, zeros past
    its end: padded rows as ``np.stack`` of the padded clips gives them, and
    unpadded ones (wider rows, as ``predict_batch``'s ``max_duration``
    path uses) with the clip's length; the counters count the call."""
    monkeypatch.setattr(taudio, "have_ffmpeg", lambda: False)
    if case == "python_parser":
        def no_toolchain():
            raise RuntimeError("no C++ compiler")

        monkeypatch.setattr(taudio, "_native", None)
        monkeypatch.setattr(tnative, "load", no_toolchain)
    base = _clip(tmp_path, "mono16")
    if case == "same_path_twice":
        paths = [base, _clip(tmp_path, "short"), base]
    elif case == "batch_of_1":
        paths = [_clip(tmp_path, "short")]
    elif case == "batch_of_64":
        cases = BATCH_CASES[:12]
        paths = [_clip(tmp_path, cases[i % len(cases)]) for i in range(64)]
    else:
        paths = [base, _clip(tmp_path, case)]
    for pad, extra in ((True, 0), (False, 123)):
        width = 48000 + extra
        want = [taudio.load_audio(p, sample_rate=16000, duration=3.0,
                                  pad=pad) for p in paths]
        out = np.full((len(paths), width), np.nan, np.float32)
        before = dict(vars(taudio.decode_counts))
        lengths = taudio.load_audio_batch(paths, out, sample_rate=16000,
                                          duration=3.0, pad=pad)
        after = vars(taudio.decode_counts)
        stacked = np.zeros_like(out)
        for r, w in enumerate(want):
            stacked[r, :len(w)] = w
        if pad:
            assert lengths is None
            np.testing.assert_array_equal(out[:, :48000], np.stack(want))
        else:
            assert lengths == [len(w) for w in want]
        assert out.tobytes() == stacked.tobytes()
        pooled = len(paths) if len(paths) > 1 and after["workers"] > 1 else 0
        assert {k: after[k] - before[k] for k in
                ("calls", "clips", "pooled", "pinned")} == {
            "calls": 1, "clips": len(paths), "pooled": pooled, "pinned": 0}
    if case == "python_parser":
        assert taudio._native is False


def test_load_audio_batch_refuses_a_batch_it_cannot_fill(tmp_path):
    path = _clip(tmp_path, "mono16")
    for bad in (np.zeros((1, 47999), np.float32),
                np.zeros((2, 48000), np.float32),
                np.zeros((1, 48000), np.float64),
                np.zeros((1, 96000), np.float32)[:, ::2]):
        with pytest.raises(ValueError, match="load_audio_batch needs"):
            taudio.load_audio_batch([path], bad)


def test_load_audio_batch_decodes_on_the_pool(tmp_path, monkeypatch):
    """A call of two or more clips decodes its rows off the calling thread
    on the pool, whose threads all start with it; a call of one stays on
    the calling thread."""
    import threading

    paths = [_clip(tmp_path, "mono16")] * 37
    seen = []
    inner = taudio._decode_row

    def recording(path, row, *a):
        seen.append(threading.get_ident())
        return inner(path, row, *a)

    monkeypatch.setattr(taudio, "_decode_row", recording)
    taudio.load_audio_batch(paths[:1], np.zeros((1, 48000), np.float32))
    assert seen == [threading.get_ident()]
    seen.clear()
    taudio.load_audio_batch(paths, np.zeros((37, 48000), np.float32))
    workers = taudio.decode_counts.workers
    assert workers == min(len(os.sched_getaffinity(0)),
                          taudio._MAX_DECODE_THREADS)
    pool = {t.ident for t in threading.enumerate()
            if t.name.startswith("radad-decode")}
    assert len(pool) == workers
    if workers > 1:
        assert set(seen) <= pool
