"""Top-k selection kernels of the flat search.

Counterpart: ``radad_tpu/ops/topk.py``:

* ``extract_candidates`` (per-tile top-m for the certified search's
  candidate select), kernel ``radad_tpu_torch/csrc/extract_candidates.cu``;
* ``flat_topk`` (fused scan + per-tile k-select, reached through
  ``FlatIndex(use_pallas=True)``), kernel
  ``radad_tpu_torch/csrc/flat_topk.cu``, with ``flat_topk_reference``.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``extract_candidates_plain``, the XLA loop of
``radad_tpu/index/flat.py::_hier_candidates``; ``flat_topk_plain``) only for
CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from radad_tpu_torch.ops import _native

LANES = 128
NEG_INF = float("-inf")
_TILE_N = 128  # rows per flat_topk kernel block (csrc/flat_topk.cu kTileN)
_STAGE_D = 64  # columns per stage of its bf16 body's ring (kMC)
_X_KIND = {torch.float32: 0, torch.bfloat16: 1}


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Top-k along the last axis, lower index first among ties (the order
    ``jax.lax.top_k`` gives)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
    rc = fn(cand.data_ptr(), tsel.data_ptr(), vals.data_ptr(),
            rows.data_ptr(), left.data_ptr(), b, t, m, nt,
            _native.stream_of(cand))
    _native.check_launch("extract_candidates", rc)
    extract_candidates.launches += 1
    shape = f"T={t} m={m}"
    extract_candidates.shape_launches[shape] = (
        extract_candidates.shape_launches.get(shape, 0) + 1)
    return vals, rows, left


extract_candidates.launches = 0  # kernel launches (never the CPU plain version)
# the same, per "T=<tiles> m=<rounds>": the certified search's T = 24, m = 8
# at k = 5; SQ8's T = 8, m = 5
extract_candidates.shape_launches = {}


# ----------------------------------------------------------------------
def _finish_topk(vals: torch.Tensor, idx: torch.Tensor, q: torch.Tensor,
                 l2: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Missing slots → index -1; for L2 add ``-|q|^2`` back to the finite
    values, so they are true negative squared distances."""
    ok = torch.isfinite(vals)
    idx = torch.where(ok, idx, torch.full_like(idx, -1)).to(torch.int32)
    if l2:
        qsq = q.float().square().sum(-1, keepdim=True)
        vals = torch.where(ok, vals - qsq, vals)
    return vals, idx


def _check_flat_topk(q, vectors, k, metric):
    if metric not in ("IP", "COSINE", "L2"):
        raise ValueError(f"flat_topk metric must be IP/COSINE/L2, got "
                         f"{metric}")
    if not 1 <= k <= LANES:
        raise ValueError(f"flat_topk supports 1 <= k <= {LANES}, got {k}")
    if q.dim() != 2 or vectors.dim() != 2 or q.shape[1] != vectors.shape[1]:
        raise ValueError(f"flat_topk: want q [B, D] and vectors [N, D], got "
                         f"{tuple(q.shape)} and {tuple(vectors.shape)}")


def flat_topk_plain(q: torch.Tensor, vectors: torch.Tensor, k: int, *,
                    metric: str = "L2", n_valid: Optional[int] = None,
                    ids: Optional[torch.Tensor] = None,
                    exclude_ids: Optional[torch.Tensor] = None,
                    fast_scan: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``flat_topk``: the full ``[B, N]`` score
    matrix (bf16-rounded operands with ``fast_scan``, f32 products), masks,
    one stable top-k. The same result as the kernel's per-tile top-k and
    merge, whose ties also fall to the lowest row."""
    _check_flat_topk(q, vectors, k, metric)
    n = vectors.shape[0]
    n_valid = n if n_valid is None else min(int(n_valid), n)
    x = vectors.float()
    qm, xm = q.float(), x
    if fast_scan:
        qm = qm.to(torch.bfloat16).float()
        xm = x.to(torch.bfloat16).float()
    scores = qm @ xm.t()
    l2 = metric == "L2"
    if l2:
        scores = 2.0 * scores - x.square().sum(-1)[None, :]
    mask = (torch.arange(n, device=q.device) >= n_valid)[None, :]
    if ids is not None and exclude_ids is not None:
        mask = mask | (ids[None, :] == exclude_ids[:, None])
    scores = scores.masked_fill(mask, NEG_INF)
    if n < k:
        scores = torch.nn.functional.pad(scores, (0, k - n), value=NEG_INF)
    vals, idx = top_k_stable(scores, k)
    return _finish_topk(vals, idx, q, l2)


def flat_topk_reference(q: torch.Tensor, vectors: torch.Tensor, k: int, *,
                        metric: str = "L2", n_valid: Optional[int] = None,
                        ids: Optional[torch.Tensor] = None,
                        exclude_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle with ``flat_topk``'s contract (JAX ``flat_topk_reference``):
    f32 scores ``-(|q|^2 - 2 q.x + |x|^2)`` (L2) or ``q.x``, masks, top-k."""
    _check_flat_topk(q, vectors, k, metric)
    qf, x = q.float(), vectors.float()
    n = x.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    scores = qf @ x.t()
    if metric == "L2":
        scores = -(qf.square().sum(-1, keepdim=True) - 2.0 * scores
                   + x.square().sum(-1)[None, :])
    mask = (torch.arange(n, device=q.device) >= n_valid)[None, :]
    if ids is not None and exclude_ids is not None:
        mask = mask | (ids[None, :] == exclude_ids[:, None])
    vals, idx = top_k_stable(scores.masked_fill(mask, NEG_INF), k)
    ok = torch.isfinite(vals)
    return vals, torch.where(ok, idx, torch.full_like(idx, -1)).to(
        torch.int32)


def flat_topk(q: torch.Tensor, vectors: torch.Tensor, k: int, *,
              metric: str = "L2", n_valid: Optional[int] = None,
              ids: Optional[torch.Tensor] = None,
              exclude_ids: Optional[torch.Tensor] = None,
              fast_scan: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k scan → ``(scores [B, k] f32, larger is better; rows
    [B, k] int32)``. ``q [B, D] f32``, ``vectors [N, D]`` f32 or bf16.
    Rows ``>= n_valid`` and rows whose ``ids`` equal the query's
    ``exclude_ids`` are masked; missing slots are ``(-inf, -1)``. L2 scores
    are ``-|q - x|^2``. ``fast_scan`` rounds q and x to bf16 for the
    products (f32 sums), as the JAX kernel's single-pass MXU scan.

    The kernel gives each 128-row tile's top k; the ``[B, tiles * k]``
    candidates merge with a stable top-k here (the JAX wrapper's
    ``lax.top_k``)."""
    _check_flat_topk(q, vectors, k, metric)
    if (ids is None) != (exclude_ids is None):
        raise ValueError("flat_topk: ids and exclude_ids come together")
    tensors = [q, vectors] + ([] if ids is None else [ids, exclude_ids])
    if all(t.device.type == "cpu" for t in tensors):
        return flat_topk_plain(q, vectors, k, metric=metric, n_valid=n_valid,
                               ids=ids, exclude_ids=exclude_ids,
                               fast_scan=fast_scan)
    _native.require_cuda("flat_topk", *tensors)
    b, d = q.shape
    n = vectors.shape[0]
    kind = _X_KIND.get(vectors.dtype)
    if q.dtype != torch.float32 or kind is None:
        raise TypeError(f"flat_topk: want q f32 and vectors f32 or bf16, got "
                        f"{q.dtype} and {vectors.dtype}")
    if ids is not None and (ids.dtype != torch.int32
                            or exclude_ids.dtype != torch.int32
                            or ids.shape != (n,)
                            or exclude_ids.shape != (b,)):
        raise TypeError("flat_topk: want ids [N] and exclude_ids [B] int32")
    if d % 4 or q.data_ptr() % 16 or vectors.data_ptr() % 16:
        raise ValueError("flat_topk: the kernel needs D % 4 == 0 and "
                         "16-byte aligned q and vectors")
    if b > 64 * 65_535:
        raise ValueError(f"flat_topk: B={b} exceeds the kernel's grid")
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    tiles = -(-n // _TILE_N)
    vals = torch.empty((b, tiles, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, tiles, k), dtype=torch.int32, device=q.device)
    if b == 0 or n == 0:
        return (torch.full((b, k), NEG_INF, device=q.device),
                torch.full((b, k), -1, dtype=torch.int32, device=q.device))
    # the bf16 body rounds q once into this scratch, rows padded to whole
    # ring stages
    q_bf16 = (torch.empty((b, -(-d // _STAGE_D) * _STAGE_D),
                          dtype=torch.bfloat16, device=q.device)
              if fast_scan else None)
    fn = _native.library("flat_topk").radad_flat_topk
    rc = fn(q.data_ptr(), None if q_bf16 is None else q_bf16.data_ptr(),
            vectors.data_ptr(),
            None if ids is None else ids.data_ptr(),
            None if ids is None else exclude_ids.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), b, n, n_valid, d, k, kind,
            int(fast_scan), int(metric == "L2"), _native.stream_of(q))
    _native.check_launch("flat_topk", rc)
    flat_topk.launches += 1
    top, pos = top_k_stable(vals.reshape(b, tiles * k), k)
    return _finish_topk(top, idx.reshape(b, tiles * k).gather(1, pos), q,
                        metric == "L2")


flat_topk.launches = 0  # kernel launches (never the CPU plain version)
