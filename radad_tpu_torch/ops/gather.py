"""Row gather ``out[m] = x[clip(idx[m], 0, N-1)]``: the serving path's
neighbor fetch.

Counterpart: ``radad_tpu/ops/gather.py`` (Pallas ``gather_rows``). The
kernel is ``radad_tpu_torch/csrc/gather_rows.cu``. The TPU version needs
the table re-laid out as ``[N, D/128, 128]`` for its row DMA; here rows
stay ``[N, D]``, so there is no ``to_gather_layout``.

``gather_rows`` launches the kernel for CUDA tensors and runs
``gather_rows_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from radad_tpu_torch.ops import _native


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x [N, D]``, ``idx [M]`` → ``[M, D]``."""
    safe = idx.long().clamp(0, x.shape[0] - 1)
    return x.index_select(0, safe)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [N, D]`` (any dtype), ``idx [M] int32`` → ``x[idx] [M, D]``.

    Out-of-range and negative indices are clamped to ``[0, N)``, as
    ``jnp.take`` clips on the TPU; callers mask invalid rows themselves.
    """
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows: want x [N, D] and idx [M], got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if x.shape[0] == 0:
        raise ValueError("gather_rows: empty table")
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_plain(x, idx)
    _native.require_cuda("gather_rows", x, idx)
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows: idx must be int32, got {idx.dtype}")
    n, d = x.shape
    m = idx.shape[0]
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    row_bytes = d * x.element_size()
    if m == 0:
        return out
    if row_bytes % 2:
        raise ValueError(f"gather_rows: row of {row_bytes} bytes is not "
                         f"a multiple of 2")
    fn = _native.library("gather_rows").radad_gather_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), n, row_bytes, m,
            _native.stream_of(x))
    _native.check_launch("gather_rows", rc)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0  # kernel launches (never the CPU plain version)
