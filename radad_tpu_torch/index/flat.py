"""Device-resident flat vector index with certified-exact search.

Counterpart: ``radad_tpu/index/flat.py`` (``FlatIndex`` for L2, IP and
COSINE; ``_hier_candidates``, ``_search_fast_exact``, ``_search_device``).
IVF waits for a later slice and raises.

Search is the JAX package's certified fast-exact route on every device:
one bf16 scan with a hi/lo query split and a bf16 residual term (f32
accumulation), a deep strided-tile candidate select by the rounding-error
upper bound (``ops.topk.extract_candidates``), exact f32 re-scoring of the
top candidates (``ops.rerank.exact_dot``), and a certificate: when some row
that was not re-scored could still beat the k-th exact score, the search
falls back to a full f32 scan. That branch is a host ``if`` on one bool
(``lax.cond`` in JAX); ``FlatIndex.fallbacks`` counts it.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values, and
``torch.topk`` leaves their order unspecified on CUDA, so every select
whose ids must match JAX is a stable descending sort, sliced.

Persistence writes the JAX package's files (``index_arrays.npz``,
``index_meta.json``, ``index_host.pkl``), so an index saved by either
package loads in the other. Paths and metadata stay host-side.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from radad_tpu_torch.ops.rerank import exact_dot
from radad_tpu_torch.ops.topk import LANES, extract_candidates
from radad_tpu_torch.utils.device import resolve_device

_PAD = 1024  # capacity quantum, as in the JAX package
NEG_INF = float("-inf")


def _round_up(n: int, m: int = _PAD) -> int:
    return max(m, ((n + m - 1) // m) * m)


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Top-k along the last axis, lower index first among ties (the order
    ``jax.lax.top_k`` gives)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def bf16_mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` for bf16 operands with an f32 accumulator and f32
    output. On CUDA ``aten::mm.dtype``; on the CPU (which has no such
    kernel) an f32 product of the upcast operands, the same numbers: bf16
    products are exact in f32."""
    if a.is_cuda:
        return torch.mm(a, b.t(), out_dtype=torch.float32)
    return torch.mm(a.float(), b.float().t())


class FlatIndex:
    """Brute-force (exact) index over clip embeddings.

    Device state: ``vectors [cap, D]`` (f32, or bf16 with
    ``use_float16``), ``labels [cap] f32``, ``ids [cap] int32`` (basename
    id per row, for self-exclusion), ``norms_sq [cap] f32``, and the scan
    arrays ``scan_bf16`` / ``resid_bf16``; rows ``>= n`` are masked out of
    every search. Host state: paths and metadata lists."""

    metric_kinds = ("L2", "IP", "COSINE")

    def __init__(self, dimension: int, metric: str = "L2", *,
                 use_float16: bool = False, add_batch_size: int = 10000,
                 device="cuda"):
        metric = metric.upper()
        if metric == "IVF":
            raise NotImplementedError("IVF index: not yet ported")
        if metric not in self.metric_kinds:
            raise ValueError(f"Unknown index metric: {metric}")
        self.dimension = int(dimension)
        self.metric = metric
        self.use_float16 = bool(use_float16)
        self.add_batch_size = int(add_batch_size)
        self.device = resolve_device(device)
        self.n = 0
        self._cap = 0
        self.vectors: Optional[torch.Tensor] = None
        self.labels: Optional[torch.Tensor] = None
        self.ids: Optional[torch.Tensor] = None
        self.norms_sq: Optional[torch.Tensor] = None
        self.scan_bf16: Optional[torch.Tensor] = None
        self.resid_bf16: Optional[torch.Tensor] = None
        self.paths: List[str] = []
        self.metadata: List[dict] = []
        # saved-meta keys this port does not use (IVF knobs), kept so a
        # JAX-written index round-trips unchanged
        self._meta_extra: dict = {}
        self.search_chunk = 2048
        self.searches = 0  # certified searches run
        self.fallbacks = 0  # of which failed the certificate

    @property
    def ntotal(self) -> int:
        return self.n

    # ------------------------------------------------------------------
    def add(self, vectors, labels: Sequence[float], paths: Sequence[str],
            metadata: Optional[Sequence[dict]] = None,
            ids: Optional[Sequence[int]] = None) -> None:
        """Append rows (reference vector_database.py:108-151). ``vectors``
        is a numpy array or a tensor on any device."""
        from radad_tpu_torch.data.manifest import file_id

        vec = torch.as_tensor(vectors).to(self.device, torch.float32)
        if vec.dim() != 2 or vec.shape[1] != self.dimension:
            raise ValueError(f"expected [N, {self.dimension}] vectors, got "
                             f"{tuple(vec.shape)}")
        n_new = vec.shape[0]
        if not (len(labels) == len(paths) == n_new):
            raise ValueError("labels/paths length mismatch with vectors")
        if self.metric == "COSINE":
            vec = vec / vec.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        if ids is None:
            ids = [file_id(p) for p in paths]
        lab = torch.as_tensor(np.asarray(labels, np.float32),
                              device=self.device)
        idc = torch.as_tensor(np.asarray(ids, np.int32), device=self.device)
        self.paths.extend(list(paths))
        self.metadata.extend(list(metadata) if metadata is not None
                             else [{} for _ in range(n_new)])
        need = self.n + n_new
        if need > self._cap:
            self._grow_to(_round_up(max(need, 2 * self._cap)))
        bs = self.add_batch_size or n_new
        for lo in range(0, n_new, bs):
            hi = min(n_new, lo + bs)
            self._write_rows(self.n + lo, vec[lo:hi], lab[lo:hi],
                             idc[lo:hi])
        self.n = need

    def _grow_to(self, cap: int) -> None:
        """Reallocate the device arrays at capacity ``cap`` (a multiple
        of 1024), keeping the rows written so far."""
        dev, d = self.device, self.dimension
        store = torch.bfloat16 if self.use_float16 else torch.float32

        def grown(old, shape, dtype, fill=0):
            new = torch.full(shape, fill, dtype=dtype, device=dev)
            if old is not None:
                new[: old.shape[0]] = old
            return new

        self.vectors = grown(self.vectors, (cap, d), store)
        self.labels = grown(self.labels, (cap,), torch.float32)
        self.ids = grown(self.ids, (cap,), torch.int32, fill=-1)
        self.norms_sq = grown(self.norms_sq, (cap,), torch.float32)
        if self.use_float16:
            self.scan_bf16 = self.vectors  # bf16 storage IS the scan copy
        else:
            self.scan_bf16 = grown(self.scan_bf16, (cap, d), torch.bfloat16)
            self.resid_bf16 = grown(self.resid_bf16, (cap, d),
                                    torch.bfloat16)
        self._cap = cap

    def _write_rows(self, start: int, vec: torch.Tensor, lab: torch.Tensor,
                    idc: torch.Tensor) -> None:
        """Install f32 rows at ``start``: stored rows, exact norms of the
        stored rows, and (f32 storage) their bf16 scan copy and bf16
        rounding residual, the x-side correction of the certified scan."""
        end = start + vec.shape[0]
        self.vectors[start:end] = vec
        stored = self.vectors[start:end].float()
        self.norms_sq[start:end] = stored.square().sum(-1)
        self.labels[start:end] = lab
        self.ids[start:end] = idc
        if not self.use_float16:
            hi = vec.to(torch.bfloat16)
            self.scan_bf16[start:end] = hi
            self.resid_bf16[start:end] = (vec - hi.float()).to(
                torch.bfloat16)

    # ------------------------------------------------------------------
    def search(self, queries, k: int, *, exclude_ids=None,
               _ids=None, _exclude_mode: str = "batch"
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k: → (distances [B, k], row indices [B, k] int64). Missing
        slots (k > matches) are index -1 with distance +inf (L2) or -inf
        (IP/COSINE). ``exclude_ids [B]`` masks rows whose stored id is in
        the batch's set (the reference's batch-global self-filter,
        pipeline.py:461-463,494-501)."""
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        b = q.shape[0]
        if self.n == 0:
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int64))
        if b > self.search_chunk:
            # one call-global exclusion union, folded into the id column
            # once (the -3 sentinel), then fixed-size chunks in "self" mode
            ids_use, ex_chunk = None, None
            if exclude_ids is not None:
                ex = torch.as_tensor(np.asarray(exclude_ids, np.int32),
                                     device=self.device)
                ids_use = torch.where(torch.isin(self.ids, ex),
                                      torch.full_like(self.ids, -3),
                                      self.ids)
                ex_chunk = np.full((self.search_chunk,), -3, np.int32)
            dd, ii = [], []
            for lo in range(0, b, self.search_chunk):
                d, i = self.search(q[lo:lo + self.search_chunk], k,
                                   exclude_ids=None if ex_chunk is None
                                   else ex_chunk[:min(self.search_chunk,
                                                      b - lo)],
                                   _ids=ids_use, _exclude_mode="self")
                dd.append(d)
                ii.append(i)
            return np.concatenate(dd), np.concatenate(ii)
        if self.metric == "COSINE":
            q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        if exclude_ids is None:
            ex = torch.full((b,), -2, dtype=torch.int32, device=self.device)
        else:
            ex = torch.as_tensor(np.asarray(exclude_ids, np.int32),
                                 device=self.device)
        dists, idx, fell_back = _search_device(
            q, self.vectors, self.ids if _ids is None else _ids, ex, k,
            metric=self.metric, n_valid=self.n, xsq=self.norms_sq,
            scan_bf16=self.scan_bf16, resid_bf16=self.resid_bf16,
            exclude_mode=_exclude_mode)
        self.count_search(fell_back)
        return dists.cpu().numpy(), idx.cpu().numpy().astype(np.int64)

    def count_search(self, fell_back: bool) -> None:
        self.searches += 1
        self.fallbacks += int(fell_back)

    # ------------------------------------------------------------------
    def save(self, directory: str) -> None:
        """The JAX package's files, each written atomically."""
        from radad_tpu_torch.utils.atomic_io import (atomic_json_dump,
                                                     atomic_pickle_dump,
                                                     atomic_savez)

        os.makedirs(directory, exist_ok=True)
        n = self.n
        empty = np.zeros((0,), np.float32)
        arrays = dict(
            vectors=(self.vectors[:n].float().cpu().numpy() if n
                     else np.zeros((0, self.dimension), np.float32)),
            labels=self.labels[:n].cpu().numpy() if n else empty,
            ids=(self.ids[:n].cpu().numpy() if n
                 else np.zeros((0,), np.int32)))
        atomic_savez(os.path.join(directory, "index_arrays.npz"), **arrays)
        meta = dict(self._meta_extra)
        meta.update(dimension=self.dimension, metric=self.metric, n=n,
                    use_float16=self.use_float16)
        for key, default in (("nlist", 0), ("nprobe", 32),
                             ("single_buffer", False), ("kmeans_iters", 25),
                             ("ivf_balance", 0.0),
                             ("ivf_retrain_on_add", True)):
            meta.setdefault(key, default)
        atomic_json_dump(meta, os.path.join(directory, "index_meta.json"))
        atomic_pickle_dump({"paths": self.paths, "metadata": self.metadata},
                           os.path.join(directory, "index_host.pkl"))

    @classmethod
    def load(cls, directory: str, *, device="cuda") -> "FlatIndex":
        with open(os.path.join(directory, "index_meta.json")) as f:
            meta = json.load(f)
        idx = cls(meta["dimension"], meta["metric"],
                  use_float16=meta.get("use_float16", False), device=device)
        idx._meta_extra = {k: v for k, v in meta.items()
                           if k not in ("dimension", "metric", "n",
                                        "use_float16")}
        data = np.load(os.path.join(directory, "index_arrays.npz"))
        if "centroids" in data:
            raise NotImplementedError("IVF index: not yet ported")
        # index_host.pkl is written by this package or the JAX package
        # beside the arrays; it is trusted like the rest of the directory
        with open(os.path.join(directory, "index_host.pkl"), "rb") as f:
            host = pickle.load(f)
        vectors = data["vectors"]
        if len(vectors):
            idx.add(vectors, data["labels"].tolist(), list(host["paths"]),
                    metadata=list(host["metadata"]),
                    ids=data["ids"].tolist())
        return idx


# ----------------------------------------------------------------------
def _hier_candidates(scores: torch.Tensor, k: int, tiles_hint: int = None,
                     per_tile_hint: int = None):
    """Exact hierarchical candidate selection over masked scores
    ``[B, cap]``: per-tile top-m of the top-T tiles by tile max, over
    STRIDED tiles (tile t = rows t, t+nt, t+2nt, ...; contiguous
    near-duplicate rows spread over tiles). Provably ⊇ the exact
    top-min(T, m). Returns (cand_scores [B, T*m], cand_rows [B, T*m] int32,
    spill [B]), ``spill`` the max score among non-candidates."""
    b, cap = scores.shape
    pad = (-cap) % LANES
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
    nt = (cap + pad) // LANES
    tiles = min(max(8, k) if tiles_hint is None else max(tiles_hint, k), nt)
    per_tile = max(5 if per_tile_hint is None else per_tile_hint, k)
    st = scores.reshape(b, LANES, nt).transpose(1, 2)  # [B, nt, 128] view
    tmax = st.amax(-1)  # [B, nt]
    _, tsel = top_k_stable(tmax, tiles)  # [B, T]
    cand = st.gather(1, tsel[:, :, None].expand(b, tiles, LANES))
    unsel_max = tmax.scatter(1, tsel, NEG_INF).amax(-1)
    vals, rows, leftover = extract_candidates(
        cand.contiguous(), tsel.to(torch.int32), per_tile, nt)
    spill = torch.maximum(leftover.amax(-1), unsel_max)
    return vals, rows, spill


def _search_fast_exact(q, scan_bf16, xsq, mask, k, larger_better, vectors,
                       resid_bf16=None, rerank_depth=None):
    """Certified fast-exact search (JAX ``_search_fast_exact`` with
    ``vectors`` given). → (dists [B, k], idx [B, k] int32, certified)."""
    b, _ = q.shape
    cap = scan_bf16.shape[0]
    qf = q.float()
    qsq = qf.square().sum(-1, keepdim=True)
    metric_fac = 2.0 if not larger_better else 1.0  # L2 doubles dot error

    # q·x ≈ q_hi·x_bf + q_lo·x_bf + q_hi·r (r = bf16(x - x_bf)); the two
    # q-side terms are one stacked [2B, D] product so x_bf is read once.
    # Error ≤ ~1.6·2⁻¹⁷·‖q‖·‖x‖ with an f32 accumulator and f32 output;
    # a bf16 output (torch's default for bf16 @ bf16) would break it.
    q_hi = q.to(torch.bfloat16)
    if resid_bf16 is not None or vectors.dtype == torch.bfloat16:
        q_lo = (qf - q_hi.float()).to(torch.bfloat16)
        out2 = bf16_mm_f32(torch.cat([q_hi, q_lo]), scan_bf16)
        qx = out2[:b] + out2[b:]
        if resid_bf16 is not None:
            qx = qx + bf16_mm_f32(q_hi, resid_bf16)
        mfac = metric_fac * 1.3 * 2.0 ** -16
    else:
        qx = bf16_mm_f32(q_hi, scan_bf16)
        mfac = metric_fac * 1.25 * 2.0 ** -8
    scores = qx if larger_better else -(qsq - 2.0 * qx + xsq[None, :])
    scores = scores.masked_fill(mask, NEG_INF)

    qnorm = qsq.squeeze(-1).clamp_min(0.0).sqrt()
    rownorm = xsq.clamp_min(0.0).sqrt()
    ub = (scores + mfac * qnorm[:, None] * rownorm[None, :]).masked_fill(
        mask, NEG_INF)

    cand_ub, cand_rows, spill_ub = _hier_candidates(
        ub, k, tiles_hint=max(24, 2 * k), per_tile_hint=8)
    r_all = cand_ub.shape[1]
    r2 = min(r_all, max(32, 2 * k) if rerank_depth is None
             else max(rerank_depth, k))
    sel_ub, sel = top_k_stable(cand_ub, min(r2 + 1, r_all))
    if r2 < r_all:
        unreranked_ub = sel_ub[:, -1]  # max UB among non-re-scored
        sel_ub, sel = sel_ub[:, :r2], sel[:, :r2]
    else:
        unreranked_ub = torch.full((b,), NEG_INF, device=q.device)
    rows2 = cand_rows.gather(1, sel)  # [B, r2]
    safe = rows2.clamp(0, cap - 1).to(torch.int32)

    qc = exact_dot(qf.contiguous(), vectors, safe)
    if larger_better:
        exact = qc
    else:
        exact = -(qsq - 2.0 * qc + xsq[safe.long()])
    exact = exact.masked_fill(~torch.isfinite(sel_ub), NEG_INF)
    top_scores, pos = top_k_stable(exact, k)
    top_idx = rows2.gather(1, pos)
    valid = torch.isfinite(top_scores)
    miss = NEG_INF if larger_better else float("inf")
    dists = torch.where(valid, top_scores if larger_better else -top_scores,
                        torch.full_like(top_scores, miss))
    idx = torch.where(valid, top_idx, torch.full_like(top_idx, -1))

    # outer certificate: the k-th exact score vs the best upper bound of
    # any row that was not exactly re-scored
    worst_other = torch.maximum(spill_ub, unreranked_ub)
    certified = bool(((top_scores[:, -1] >= worst_other)
                      | ~torch.isfinite(worst_other)).all())
    return dists, idx.to(torch.int32), certified


def _full_scan(q, vectors, xsq, mask, k, larger_better):
    """Exact f32 scan (TF32 off) + stable top-k: the certificate's
    fallback."""
    qf = q.float()
    qx = qf @ vectors.float().t()
    s = qx if larger_better else -(qf.square().sum(-1, keepdim=True)
                                   - 2.0 * qx + xsq[None, :])
    ts, ti = top_k_stable(s.masked_fill(mask, NEG_INF), k)
    ok = torch.isfinite(ts)
    miss = NEG_INF if larger_better else float("inf")
    dd = torch.where(ok, ts if larger_better else -ts,
                     torch.full_like(ts, miss))
    return dd, torch.where(ok, ti, torch.full_like(ti, -1)).to(torch.int32)


def _search_device(q, vectors, ids, exclude_ids, k, *, metric, n_valid, xsq,
                   scan_bf16, resid_bf16=None, exclude_mode="batch",
                   rerank_depth=None):
    """Score + mask + certified k-select. → (dists [B, k], idx [B, k]
    int32, fell_back).

    ``exclude_mode="batch"``: ONE exclusion set from the whole query
    batch's ids (reference parity, pipeline.py:461-463); ``"self"``: each
    query excludes only its own id."""
    if exclude_mode == "batch":
        ids = torch.where(torch.isin(ids, exclude_ids),
                          torch.full_like(ids, -3), ids)
        exclude_ids = torch.full((q.shape[0],), -3, dtype=torch.int32,
                                 device=q.device)
    cap = vectors.shape[0]
    larger_better = metric in ("IP", "COSINE")
    invalid_row = torch.arange(cap, device=q.device) >= n_valid
    mask = invalid_row[None, :] | (ids[None, :] == exclude_ids[:, None])
    dists, idx, certified = _search_fast_exact(
        q, scan_bf16, xsq, mask, k, larger_better, vectors,
        resid_bf16=resid_bf16, rerank_depth=rerank_depth)
    if certified:
        return dists, idx, False
    dists, idx = _full_scan(q, vectors, xsq, mask, k, larger_better)
    return dists, idx, True
