"""Temporal Pyramid Pooling: ``[..., T, D]`` → ``[..., sum(levels) * D]``.

Counterpart: ``radad_tpu/ops/tpp.py``. Bin ``i`` of ``level`` bins over
``T`` frames covers ``[floor(i*T/level), ceil((i+1)*T/level))``, torch's
adaptive-pooling edges (reference pooling.py:66-103); within a level the
output is bin-major and levels concatenate in config order (5376 for
D = 768, levels (1, 2, 4)).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def tpp_output_dim(levels: Sequence[int], feature_dim: int) -> int:
    """pooling.py:119-122."""
    return sum(levels) * feature_dim


def _bin_edges(t: int, level: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((math.floor(i * t / level), math.ceil((i + 1) * t / level))
                 for i in range(level))


def temporal_pyramid_pool(features: torch.Tensor,
                          levels: Sequence[int] = (1, 2, 4),
                          pooling_type: str = "max") -> torch.Tensor:
    """Pool ``features [..., T, D]`` → ``[..., sum(levels)*D]``."""
    if pooling_type not in ("max", "avg"):
        raise ValueError(f"Unsupported pooling type: {pooling_type}")
    t = features.shape[-2]
    outs = []
    for level in levels:
        for start, end in _bin_edges(t, level):
            window = features[..., start:end, :]
            outs.append(window.amax(-2) if pooling_type == "max"
                        else window.mean(-2))
    return torch.cat(outs, dim=-1)
