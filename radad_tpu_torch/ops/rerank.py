"""Fused candidate rerank: exact f32 ``q[b] · x[idx[b, r]]`` without
materializing the gathered rows.

Counterpart: ``radad_tpu/ops/rerank.py`` (Pallas ``exact_dot`` and
``exact_dot_reference``). The kernel is
``radad_tpu_torch/csrc/exact_dot.cu``. The TPU kernel takes the table in
its ``[N, D/128, 128]`` gather layout; here ``q`` and ``x`` stay 2-D.

``exact_dot`` launches the kernel for CUDA tensors and runs
``exact_dot_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from radad_tpu_torch.ops import _native

_X_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def exact_dot_plain(q: torch.Tensor, x: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, cast to f32, multiply, sum over D."""
    safe = idx.long().clamp(0, x.shape[0] - 1)
    cv = x[safe].float()  # [B, R, D]
    return (cv * q.float()[:, None, :]).sum(-1)


def exact_dot(q: torch.Tensor, x: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """``q [B, D] f32``, ``x [N, D]`` f32/bf16/int8, ``idx [B, R] int32``
    → ``[B, R] f32`` exact dots (f32 FMA, no TF32).

    int8 rows are cast in the kernel; the caller multiplies the output by
    any per-row scales. Indices are clamped to ``[0, N)``: callers mask
    invalid candidates by score, not by index."""
    if q.dim() != 2 or x.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"exact_dot: want q [B, D], x [N, D], idx [B, R], "
                         f"got {tuple(q.shape)}, {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}")
    b, d = q.shape
    if x.shape[1] != d or idx.shape[0] != b:
        raise ValueError(f"exact_dot: shape mismatch {tuple(q.shape)}, "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}")
    if x.shape[0] == 0:
        raise ValueError("exact_dot: empty table")
    if all(t.device.type == "cpu" for t in (q, x, idx)):
        return exact_dot_plain(q, x, idx)
    _native.require_cuda("exact_dot", q, x, idx)
    if q.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"exact_dot: want q f32 and idx int32, got "
                        f"{q.dtype} and {idx.dtype}")
    kind = _X_KIND.get(x.dtype)
    if kind is None:
        raise TypeError(f"exact_dot: x must be f32, bf16 or int8, "
                        f"got {x.dtype}")
    if d % 4 or q.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("exact_dot: the kernel needs D % 4 == 0 and "
                         "16-byte aligned q and x")
    if d * 4 > 227 * 1024:
        raise ValueError(f"exact_dot: D={d} does not fit shared memory")
    r = idx.shape[1]
    out = torch.empty((b, r), dtype=torch.float32, device=q.device)
    if b == 0 or r == 0:
        return out
    fn = _native.library("exact_dot").radad_exact_dot
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), x.data_ptr(), idx.data_ptr(), out.data_ptr(), b,
            x.shape[0], d, r, kind, _native.stream_of(q))
    _native.check_launch("exact_dot", rc)
    exact_dot.launches += 1
    return out


exact_dot.launches = 0  # kernel launches (never the CPU plain version)
