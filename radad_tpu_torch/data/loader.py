"""Host-side batched audio loader with threaded decode and prefetch.

Counterpart: ``radad_tpu/data/loader.py``, copied.

Replaces the reference's ``torch.utils.data.DataLoader`` worker processes
(``reference/pipeline.py:418-422,776-780``, ``main.py:60``). Decode is
I/O + light DSP, so threads (no pickling, shared numpy) beat fork workers;
each yielded batch is one contiguous ``[B, clip_samples]`` float32 array —
a single host→device transfer per batch instead of per-item tensors.

Batches are FIXED SIZE: the final partial batch is zero-padded and carries a
``valid`` mask, so every jit-compiled step sees one static shape (one
compilation, ever). Yields plain numpy; device placement happens in the
pipeline (optionally sharded across the mesh 'data' axis).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from radad_tpu_torch.data.audio import load_audio
from radad_tpu_torch.data.manifest import Manifest


@dataclasses.dataclass
class Batch:
    audio: np.ndarray  # [B, clip_samples] f32
    labels: np.ndarray  # [B] f32
    ids: np.ndarray  # [B] i32 basename ids (for self-exclusion)
    valid: np.ndarray  # [B] bool — False on zero-padded tail rows
    paths: tuple
    speakers: tuple
    # True (pre-padding) sample count per clip, capped at clip_samples.
    # Consumed by the long-audio mode's valid-window masking
    # (config.max_duration; make_embed_fn lengths arg); ignored in the
    # reference-parity path, where every clip is exactly clip_samples.
    lengths: np.ndarray = None  # [B] i32

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())


def _decode_batch(manifest: Manifest, idx: np.ndarray, batch_size: int,
                  sample_rate: int, duration: float,
                  pool: ThreadPoolExecutor,
                  pad_to: Optional[int] = None) -> Batch:
    clip = int(duration * sample_rate)
    audio = np.zeros((batch_size, max(clip, pad_to or 0)), np.float32)
    # pad=False so each clip's true length survives into Batch.lengths (the
    # zero-filled batch array supplies the padding identically).
    waves = list(pool.map(
        lambda i: load_audio(manifest.paths[i], sample_rate=sample_rate,
                             duration=duration, pad=False), idx))
    lengths = np.full((batch_size,), clip, np.int32)
    for row, w in enumerate(waves):
        audio[row, :len(w)] = w[:clip]
        lengths[row] = min(len(w), clip)
    labels = np.zeros((batch_size,), np.float32)
    ids = np.full((batch_size,), -1, np.int32)
    valid = np.zeros((batch_size,), bool)
    labels[: len(idx)] = manifest.labels[idx]
    ids[: len(idx)] = manifest.ids[idx]
    valid[: len(idx)] = True
    paths = tuple(manifest.paths[i] for i in idx) + ("",) * (batch_size - len(idx))
    speakers = tuple(manifest.speakers[i] for i in idx) + \
        ("",) * (batch_size - len(idx))
    return Batch(audio=audio, labels=labels, ids=ids, valid=valid,
                 paths=paths, speakers=speakers, lengths=lengths)


def iterate_batches(
    manifest: Manifest,
    batch_size: int,
    *,
    sample_rate: int = 16000,
    duration: float = 3.0,
    shuffle: bool = False,
    seed: int = 0,
    num_threads: int = 8,
    prefetch: int = 2,
    pad_to: Optional[int] = None,
) -> Iterator[Batch]:
    """Yield fixed-size Batches covering the manifest once.

    Decode for batch i+1..i+prefetch overlaps device compute on batch i via
    a small producer thread. ``pad_to``: widen the audio array beyond the
    duration-derived length (long-audio mode pads to the window-grid cover
    so every valid window exists in the layout; see
    pipeline.grid_cover_samples).
    """
    order = np.arange(len(manifest))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    chunks = [order[i:i + batch_size]
              for i in range(0, len(order), batch_size)]

    pool = ThreadPoolExecutor(max_workers=num_threads)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()

    def producer():
        try:
            for chunk in chunks:
                if stop.is_set():
                    return
                q.put(_decode_batch(manifest, chunk, batch_size,
                                    sample_rate, duration, pool,
                                    pad_to=pad_to))
        finally:
            q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            yield item
    finally:
        stop.set()
        # drain so the producer can exit
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:  # pragma: no cover
                break
        pool.shutdown(wait=False)


def num_batches(n_items: int, batch_size: int) -> int:
    return (n_items + batch_size - 1) // batch_size
