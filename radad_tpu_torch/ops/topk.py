"""Per-tile top-m candidate extraction for the certified flat search.

Counterpart: ``radad_tpu/ops/topk.py`` (Pallas ``extract_candidates``; the
module's ``flat_topk`` kernel, opt-in behind ``FlatIndex(use_pallas=True)``
there, is not ported yet). The kernel is
``radad_tpu_torch/csrc/extract_candidates.cu``.

``extract_candidates`` launches the kernel for CUDA tensors and runs
``extract_candidates_plain`` (the XLA loop of
``radad_tpu/index/flat.py::_hier_candidates``) only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from radad_tpu_torch.ops import _native

LANES = 128


def extract_candidates_plain(cand: torch.Tensor, tsel: torch.Tensor, m: int,
                             nt: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch version: m rounds of max → lowest lane at the max →
    mask that lane to -inf."""
    b, t, lanes = cand.shape
    col = torch.arange(lanes, device=cand.device,
                       dtype=torch.int32).expand(b, t, lanes)
    big = torch.tensor(lanes, dtype=torch.int32, device=cand.device)
    neg_inf = torch.tensor(float("-inf"), dtype=cand.dtype,
                           device=cand.device)
    c = cand
    vals, rows = [], []
    for _ in range(m):
        best = c.amax(-1)  # [B, T]
        bidx = torch.where(c >= best[..., None], col, big).amin(-1)
        vals.append(best)
        # strided layout: score row index = lane * nt + tile
        rows.append(torch.clamp(bidx, max=lanes - 1) * nt + tsel)
        c = torch.where(col == bidx[..., None], neg_inf, c)
    return (torch.cat(vals, -1), torch.cat(rows, -1).to(torch.int32),
            c.amax(-1))


def extract_candidates(cand: torch.Tensor, tsel: torch.Tensor, m: int,
                       nt: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``cand [B, T, 128] f32`` (the top-T lane tiles of the strided score
    view), ``tsel [B, T] int32`` (their tile numbers) → ``(vals [B, m*T]
    f32, rows [B, m*T] int32, leftover [B, T] f32)``, j-major.

    Tie-break: lowest lane. An all-(-inf) tile gives -inf at lane 0.
    ``leftover`` is each tile's maximum after the m rounds. Inputs must be
    free of NaN."""
    if cand.dim() != 3 or cand.shape[2] != LANES:
        raise ValueError(f"extract_candidates: want cand [B, T, 128], got "
                         f"{tuple(cand.shape)}")
    b, t, _ = cand.shape
    if tuple(tsel.shape) != (b, t):
        raise ValueError(f"extract_candidates: tsel {tuple(tsel.shape)} != "
                         f"{(b, t)}")
    if not 1 <= m <= LANES:
        raise ValueError(f"extract_candidates: m={m} outside [1, 128]")
    if cand.device.type == "cpu" and tsel.device.type == "cpu":
        return extract_candidates_plain(cand, tsel, m, nt)
    _native.require_cuda("extract_candidates", cand, tsel)
    if cand.dtype != torch.float32 or tsel.dtype != torch.int32:
        raise TypeError(f"extract_candidates: want f32 cand and int32 tsel, "
                        f"got {cand.dtype} and {tsel.dtype}")
    if cand.data_ptr() % 16:
        raise ValueError("extract_candidates: cand must be 16-byte aligned")
    dev = cand.device
    vals = torch.empty((b, m * t), dtype=torch.float32, device=dev)
    rows = torch.empty((b, m * t), dtype=torch.int32, device=dev)
    left = torch.empty((b, t), dtype=torch.float32, device=dev)
    if b * t == 0:
        return vals, rows, left
    fn = _native.library("extract_candidates").radad_extract_candidates
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(cand.data_ptr(), tsel.data_ptr(), vals.data_ptr(),
            rows.data_ptr(), left.data_ptr(), b, t, m, nt,
            _native.stream_of(cand))
    _native.check_launch("extract_candidates", rc)
    extract_candidates.launches += 1
    return vals, rows, left


extract_candidates.launches = 0  # kernel launches (never the CPU plain version)
