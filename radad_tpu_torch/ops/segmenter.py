"""Overlapped fixed-length windowing of audio clips.

Counterpart: ``radad_tpu/ops/segmenter.py``. Semantics parity with the
reference segmenter (segmenter.py:15-49):

  * ``num_segments = max(1, (N - L) // hop + 1)``;
  * windows start at ``i * hop``; samples past the end of the clip are
    zero; a clip shorter than one window gives one zero-padded window.

One gather with a cached ``[S, L]`` index matrix, on any leading batch
shape.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def num_segments(total_samples: int, segment_samples: int,
                 hop_samples: int) -> int:
    """Reference formula, segmenter.py:25."""
    return max(1, (total_samples - segment_samples) // hop_samples + 1)


@functools.lru_cache(maxsize=64)
def _window_indices(total: int, seg: int, hop: int):
    """[S, L] gather indices and validity mask (host arrays)."""
    s = num_segments(total, seg, hop)
    starts = np.arange(s, dtype=np.int64)[:, None] * hop
    offs = np.arange(seg, dtype=np.int64)[None, :]
    idx = starts + offs  # [S, L]
    mask = idx < total
    return np.where(mask, idx, 0), mask


def segment_audio(audio: torch.Tensor, segment_samples: int,
                  hop_samples: int) -> torch.Tensor:
    """Window ``audio [..., N]`` into ``[..., S, segment_samples]``."""
    total = audio.shape[-1]
    idx, mask = _window_indices(total, segment_samples, hop_samples)
    flat = torch.as_tensor(idx.reshape(-1), device=audio.device)
    windows = audio.index_select(-1, flat).reshape(
        audio.shape[:-1] + idx.shape)
    return windows * torch.as_tensor(mask, dtype=audio.dtype,
                                     device=audio.device)
