"""Scalar-quantized (int8) flat index: SQ8, plain, residual and int4-refined.

Counterpart: ``radad_tpu/index/quantized.py`` (``quantize_rows``,
``quantize_refinement``, ``unpack_refinement``, ``_sq8_search``,
``retrieve_on_device_sq8``, ``QuantizedIndex``). Rows are stored as
symmetric per-row int8 codes and one f32 scale, x̂ = s · codes with
s = max|x| / 127; residual mode (``residual_nlist > 0``) encodes x − c_cell
against a k-means codebook (``index/ivf.py``) trained on the first add,
x̂ = c_cell + s · codes; ``refine_bits=4`` adds a second residual level
packed two 4-bit codes a byte. Codes are made on the host in numpy, with
the JAX package's own code, so both packages store the same bytes; the
index files (``sq8_arrays.npz``, ``sq8_meta.json``, ``sq8_host.pkl``) are
the JAX package's, and a database moves between the two packages either
way.

A search (``_sq8_search``) quantizes each query row the same way, scans
every row with an int8 × int8 → int32 product (``int8_scan``: JAX's
``dot_general`` into int32, outside any Pallas kernel; here
``torch._int_mm``), rescales in JAX's order, adds the residual mode's exact
f32 q·c term, masks, then re-scores candidates exactly against the
dequantized rows:

* the accelerated route (``build_accel``, the default, on every device):
  the strided tile select of the flat index (``flat._hier_candidates`` at
  its default T = max(8, k) tiles, m = max(5, k) rounds: the
  ``extract_candidates`` kernel), then ``exact_dot`` on the ``[N, D]`` int8
  codes times the row scale, plus the centroid term and the int4 term (an
  f32 ``bmm`` of the unpacked nibbles). The JAX package takes this route
  only on a TPU, over a ``[cap, D/128, 128]`` copy of the codes; the port
  builds no such copy.
* ``build_accel=False``: a stable top-k over-fetch of
  ``min(max(rerank_depth, k), cap)`` (or ``max(4k, 32)``) candidates, which
  are gathered, dequantized and scored by an f32 ``bmm``.

Two findings on the JAX package are mirrored, not fixed: ``rerank_depth``
does nothing on the accelerated route, and with ``refine_bits=4`` the scan
combines the refined norms with int8 dots.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from radad_tpu_torch.index.flat import _assign_cells, _hier_candidates
from radad_tpu_torch.ops.rerank import exact_dot
from radad_tpu_torch.ops.topk import NEG_INF, top_k_stable
from radad_tpu_torch.utils.device import resolve_device

_PAD = 1024  # capacity quantum, as in the JAX package
_CHUNK = 100_000  # host rows a step of the codecs, the norms and k-means
_TRAIN_ROWS = 50_000  # the residual codebook's training sample
_INT_MM_MIN_ROWS = 32  # torch._int_mm on CUDA takes more than 16 rows


def _round_up(n: int, m: int = _PAD) -> int:
    return max(m, ((n + m - 1) // m) * m)


def quantize_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """→ (int8 codes, f32 per-row scales)."""
    scale = np.max(np.abs(x), axis=-1) / 127.0
    scale = np.maximum(scale, 1e-12)
    codes = np.clip(np.round(x / scale[:, None]), -127, 127).astype(np.int8)
    return codes, scale.astype(np.float32)


def quantize_refinement(r2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int4 refinement codec: the second residual level (x minus the int8
    reconstruction) packed two nibbles a byte → (uint8 [N, D/2] packed,
    f32 [N] scales), a step of ~1/14 of the int8 one."""
    assert r2.shape[-1] % 2 == 0, "refinement needs an even dimension"
    scale = np.maximum(np.max(np.abs(r2), axis=-1) / 7.0, 1e-12)
    q4 = np.clip(np.round(r2 / scale[:, None]), -7, 7).astype(np.int8)
    packed = ((q4[:, 0::2] & 0xF) |
              ((q4[:, 1::2] & 0xF) << 4)).astype(np.uint8)
    return packed, scale.astype(np.float32)


def _unpack_nibbles_np(packed: np.ndarray) -> np.ndarray:
    """numpy twin of ``unpack_refinement``'s nibble decode (unscaled):
    packed uint8 [..., D/2] → int8 [..., D]."""
    lo = (packed & 0xF).astype(np.int8)
    hi = (packed >> 4).astype(np.int8)
    lo = np.where(lo > 7, lo - 16, lo)
    hi = np.where(hi > 7, hi - 16, hi)
    return np.stack([lo, hi], axis=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 2,))


def unpack_refinement(packed: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """packed uint8 [..., D/2] + per-row scales [...] → f32 [..., D]
    refinement values (sign-extended 4-bit two's complement nibbles)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    vals = torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 2,))
    return vals.float() * scales[..., None]


def int8_scan(q8: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``q8 [B, D] int8`` · ``codes [cap, D] int8``ᵀ → exact ``[B, cap]``
    int32 (|sum| <= 127² D < 2³¹ for D < 133,000). On CUDA
    ``torch._int_mm`` takes more than 16 rows and K, N multiples of 8: the
    batch is padded to at least 32 rows (then sliced off), and a D or a
    capacity off the multiple of 8 raises; there is no float product."""
    b, d = q8.shape
    if d >= 133_000:
        raise ValueError(f"int8_scan: D={d} could overflow int32")
    if not q8.is_cuda:
        return torch._int_mm(q8, codes.t())
    if d % 8 or codes.shape[0] % 8:
        raise ValueError(f"int8_scan: torch._int_mm on CUDA needs D and the "
                         f"capacity to be multiples of 8, got D={d}, "
                         f"capacity {codes.shape[0]}")
    rows = max(_INT_MM_MIN_ROWS, -(-b // 8) * 8)
    if rows != b:
        q8 = torch.nn.functional.pad(q8, (0, 0, 0, rows - b))
    return torch._int_mm(q8, codes.t())[:b]


def _dequantize(rows: torch.Tensor, codes, scales, centroids=None,
                cells=None, codes2=None, scales2=None) -> torch.Tensor:
    """f32 reconstructions ``[M, D]`` of the stored rows ``rows [M]``:
    s · codes (+ c_cell) (+ the int4 level), in the JAX package's order."""
    rows = rows.long()
    out = codes[rows].float() * scales[rows][:, None]
    if centroids is not None:
        out = out + centroids[cells[rows].clamp_min(0).long()]
    if codes2 is not None:
        out = out + unpack_refinement(codes2[rows], scales2[rows])
    return out


def _sq8_search(q, v_codes, v_scale, v_norm_sq, ids, exclude_ids, k, *,
                metric, n_valid, accel=True, exclude_mode="batch",
                centroids=None, cells=None, codes2=None, scales2=None,
                rerank_depth=None):
    """int8 scan + exact re-score of dequantized candidates → (dists
    [B, k], idx [B, k] int32, dequantized neighbors [B, k, D]). Missing
    slots are index -1, distance +inf (L2) or -inf (IP/COSINE), zero
    vectors. ``accel``: the accelerated route (module docstring), else the
    top-k over-fetch. Exact with respect to the stored (quantized) rows
    among the candidates."""
    cap, d = v_codes.shape
    larger_better = metric in ("IP", "COSINE")
    q = q.float().contiguous()

    # per query row, symmetric: q ≈ q_scale · q8
    q_scale = (q.abs().amax(-1) / 127.0).clamp_min(1e-12)
    q8 = torch.clamp(torch.round(q / q_scale[:, None]), -127, 127
                     ).to(torch.int8)
    prod = int8_scan(q8, v_codes).float()
    qx = prod * (q_scale[:, None] * v_scale[None, :])
    if centroids is not None:
        # residual mode: q·x̂ = q·c_cell + s (q·codes), the centroid term
        # exact f32 ([B, nlist] product, then a gather by cell)
        qcent = q @ centroids.t()
        qx = qx + qcent[:, cells.clamp_min(0).long()]
    qsq = q.square().sum(-1, keepdim=True)
    scores = qx if larger_better else -(qsq - 2.0 * qx + v_norm_sq[None, :])

    invalid = (torch.arange(cap, device=q.device) >= n_valid)[None, :]
    if exclude_mode == "batch":
        # one exclusion set from the whole batch (reference parity,
        # pipeline.py:461-463)
        mask = invalid | torch.isin(ids, exclude_ids)[None, :]
    else:  # "self": each query excludes only its own file (predict_batch)
        mask = invalid | (ids[None, :] == exclude_ids[:, None])
    scores = scores.masked_fill(mask, NEG_INF)

    if accel:
        cand_scores, cand_idx, _ = _hier_candidates(scores, k)
        safe = cand_idx.clamp(0, cap - 1)
        flat = safe.reshape(-1).long()
        qc = exact_dot(q, v_codes, safe) * v_scale[flat].reshape(safe.shape)
        if centroids is not None:
            qc = qc + qcent.gather(
                1, cells[flat].clamp_min(0).long().reshape(safe.shape))
        if codes2 is not None:
            # the int4 term on the candidates only: gather, unpack, f32 bmm
            ref = unpack_refinement(codes2[flat], scales2[flat])
            qc = qc + torch.bmm(ref.reshape(safe.shape + (d,)),
                                q[:, :, None])[..., 0]
    else:
        # the depth floors at k: fewer than k candidates cannot fill top-k
        r = (min(max(int(rerank_depth), k), cap) if rerank_depth
             else min(max(4 * k, 32), cap))
        cand_scores, cand_idx = top_k_stable(scores, r)
        safe = cand_idx.clamp(0, cap - 1)
        flat = safe.reshape(-1)
        cand = _dequantize(flat, v_codes, v_scale, centroids, cells, codes2,
                           scales2).reshape(safe.shape + (d,))
        qc = torch.bmm(cand, q[:, :, None])[..., 0]

    if larger_better:
        exact = qc
    else:
        exact = -(qsq - 2.0 * qc + v_norm_sq[flat].reshape(safe.shape))
    exact = exact.masked_fill(~torch.isfinite(cand_scores), NEG_INF)
    top, pos = top_k_stable(exact, k)
    idx = cand_idx.long().gather(1, pos)
    ok = torch.isfinite(top)
    miss = NEG_INF if larger_better else float("inf")
    dists = torch.where(ok, top if larger_better else -top,
                        torch.full_like(top, miss))
    nb = _dequantize(idx.clamp_min(0).reshape(-1), v_codes, v_scale,
                     centroids, cells, codes2, scales2).reshape(
        idx.shape + (d,))
    neighbors = torch.where(ok[..., None], nb, torch.zeros_like(nb))
    idx = torch.where(ok, idx, torch.full_like(idx, -1))
    return dists, idx.to(torch.int32), neighbors


def retrieve_on_device_sq8(tpp, codes, scales, norm_sq, labels, ids,
                           exclude_ids, *, k, metric, n_valid, accel=True,
                           exclude_mode="batch", centroids=None, cells=None,
                           codes2=None, scales2=None, rerank_depth=None):
    """SQ8 retrieval with the contract of ``flat.retrieve_on_device``:
    → (dequantized neighbors [B, k, D], labels [B, k], dists [B, k], idx
    [B, k]); a missing neighbor is a zero vector with label 0 and index
    -1."""
    q = tpp.float()
    if metric == "COSINE":
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    dists, idx, neighbors = _sq8_search(
        q, codes, scales, norm_sq, ids, exclude_ids, k, metric=metric,
        n_valid=n_valid, accel=accel, exclude_mode=exclude_mode,
        centroids=centroids, cells=cells, codes2=codes2, scales2=scales2,
        rerank_depth=rerank_depth)
    ok = idx >= 0
    nlabels = torch.where(ok, labels[idx.clamp_min(0).long()],
                          torch.zeros_like(dists))
    return neighbors, nlabels, dists, idx


class QuantizedIndex:
    """int8 flat index with ``FlatIndex``'s search contract.

    Device state: ``codes [cap, D] int8``, ``scales``, ``norm_sq`` (|x̂|²),
    ``labels`` ([cap] f32), ``ids`` ([cap] int32, -1 past n); residual
    mode: ``centroids [nlist, D] f32``, ``cells [cap] int32``; refine mode:
    ``codes2 [cap, D/2] uint8``, ``scales2 [cap] f32``. Host state: paths,
    metadata and the codebook's numpy copy. ``route``: "sq8" (the
    accelerated route) or "sq8_overfetch" (``build_accel=False``)."""

    def __init__(self, dimension: int, metric: str = "L2", *,
                 build_accel: bool = True, capacity: Optional[int] = None,
                 residual_nlist: int = 0, kmeans_iters: int = 25,
                 refine_bits: int = 0, rerank_depth: Optional[int] = None,
                 device="cuda"):
        metric = metric.upper()
        if metric not in ("L2", "IP", "COSINE"):
            raise ValueError(f"QuantizedIndex metric must be L2/IP/COSINE, "
                             f"got {metric}")
        if refine_bits not in (0, 4):
            raise ValueError("refine_bits must be 0 or 4")
        if refine_bits and dimension % 2:
            raise ValueError("refine_bits=4 needs an even dimension")
        self.dimension = int(dimension)
        self.metric = metric
        self.residual_nlist = int(residual_nlist)
        self.kmeans_iters = int(kmeans_iters)
        self.refine_bits = int(refine_bits)
        # the over-fetch route's candidate depth (None: max(4k, 32))
        self.rerank_depth = rerank_depth
        # expected final row count: growth then allocates once
        self.capacity_hint = int(capacity) if capacity else 0
        self.build_accel = bool(build_accel)
        self.device = resolve_device(device)
        self.n = 0
        self.codes: Optional[torch.Tensor] = None
        self.scales: Optional[torch.Tensor] = None
        self.norm_sq: Optional[torch.Tensor] = None
        self.labels: Optional[torch.Tensor] = None
        self.ids: Optional[torch.Tensor] = None
        self.centroids: Optional[torch.Tensor] = None
        self.cells: Optional[torch.Tensor] = None
        self.codes2: Optional[torch.Tensor] = None
        self.scales2: Optional[torch.Tensor] = None
        self._centroids_host: Optional[np.ndarray] = None
        self.paths: List[str] = []
        self.metadata: List[dict] = []
        self.searches = 0  # searches run (search, retrieve)
        self.fallbacks = 0  # always 0: no route falls back

    @property
    def ntotal(self) -> int:
        return self.n

    @property
    def route(self) -> str:
        return "sq8" if self.build_accel else "sq8_overfetch"

    def count_search(self, fell_back: bool = False) -> None:
        self.searches += 1
        self.fallbacks += int(fell_back)

    def retrieve(self, tpp, exclude_ids, *, k: int,
                 exclude_mode: str = "batch", serving: bool = False):
        """``retrieve_on_device_sq8`` over the index, counted: ``FlatIndex.
        retrieve``'s contract (``serving`` picks no route here)."""
        del serving
        out = retrieve_on_device_sq8(
            tpp, self.codes, self.scales, self.norm_sq, self.labels,
            self.ids, exclude_ids, k=k, metric=self.metric, n_valid=self.n,
            accel=self.build_accel, exclude_mode=exclude_mode,
            rerank_depth=self.rerank_depth, **self._arrays())
        self.count_search()
        return out

    def _arrays(self) -> dict:
        """The search arrays as ``_sq8_search``'s keyword arguments."""
        return dict(centroids=self.centroids, cells=self.cells,
                    codes2=self.codes2, scales2=self.scales2)

    # ------------------------------------------------------------------
    def add(self, vectors, labels: Sequence[float], paths: Sequence[str],
            metadata: Optional[Sequence[dict]] = None,
            ids: Optional[Sequence[int]] = None) -> None:
        """Quantize on the host and append (O(new rows); rows already
        stored stay final). ``vectors``: numpy or a tensor on any device.
        Residual mode trains its codebook on the first add's first 50,000
        rows and assigns every later row against it."""
        from radad_tpu_torch.data.manifest import file_id

        if torch.is_tensor(vectors):
            vectors = vectors.detach().float().cpu().numpy()
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dimension:
            raise ValueError(f"expected [N, {self.dimension}] vectors, got "
                             f"{vectors.shape}")
        if not (len(labels) == len(paths) == len(vectors)):
            raise ValueError("labels/paths length mismatch with vectors")
        if self.metric == "COSINE":
            vectors = vectors / np.maximum(
                np.linalg.norm(vectors, axis=-1, keepdims=True), 1e-12)
        if ids is None:
            ids = [file_id(p) for p in paths]
        n_new = len(vectors)
        cells = None
        if self.residual_nlist > 0:
            cells = self._assign_or_train(vectors)
            codes = np.empty(vectors.shape, np.int8)
            scales = np.empty(n_new, np.float32)
            for lo in range(0, n_new, _CHUNK):
                hi = min(lo + _CHUNK, n_new)
                resid = vectors[lo:hi] - self._centroids_host[cells[lo:hi]]
                codes[lo:hi], scales[lo:hi] = quantize_rows(resid)
        else:
            codes, scales = quantize_rows(vectors)
        codes2 = scales2 = None
        if self.refine_bits:
            codes2 = np.empty((n_new, self.dimension // 2), np.uint8)
            scales2 = np.empty(n_new, np.float32)
            for lo in range(0, n_new, _CHUNK):
                hi = min(lo + _CHUNK, n_new)
                base = vectors[lo:hi]
                if cells is not None:
                    base = base - self._centroids_host[cells[lo:hi]]
                r2 = base - codes[lo:hi].astype(np.float32) \
                    * scales[lo:hi, None]
                codes2[lo:hi], scales2[lo:hi] = quantize_refinement(r2)
        self.paths.extend(list(paths))
        self.metadata.extend(list(metadata) if metadata is not None
                             else [{} for _ in range(n_new)])
        labels = np.asarray(labels, np.float32)
        ids = np.asarray(ids, np.int32)
        if self.n == 0:
            self._install_codes(codes, scales, labels, ids, cells=cells,
                                codes2=codes2, scales2=scales2)
        else:
            self._append_codes(codes, scales, labels, ids, cells=cells,
                               codes2=codes2, scales2=scales2)

    def _assign_or_train(self, vectors: np.ndarray) -> np.ndarray:
        """Cell of each row; the first call trains the codebook on its
        first 50,000 rows (FAISS's train-on-subset, reference
        vector_database.py:122-130), later calls assign against the frozen
        codebook so that stored codes stay final."""
        from radad_tpu_torch.index.ivf import kmeans

        if self.centroids is None:
            sample = vectors[:_TRAIN_ROWS]
            nlist = max(1, min(self.residual_nlist, len(sample)))
            cents, _ = kmeans(torch.as_tensor(sample, device=self.device),
                              nlist, iters=self.kmeans_iters, seed=0)
            self.centroids = cents
            self._centroids_host = cents.cpu().numpy()
        out = np.empty(len(vectors), np.int32)
        for lo in range(0, len(vectors), _CHUNK):
            hi = min(lo + _CHUNK, len(vectors))
            out[lo:hi] = _assign_cells(
                torch.as_tensor(vectors[lo:hi], device=self.device),
                self.centroids).cpu().numpy()
        return out

    def _norms_chunked(self, codes: np.ndarray, scales: np.ndarray,
                       cells: Optional[np.ndarray],
                       codes2: Optional[np.ndarray] = None,
                       scales2: Optional[np.ndarray] = None) -> np.ndarray:
        """|x̂|² per row on the host, chunked: the centroid in residual
        mode, the int4 level in refine mode (one nibble decode for both the
        reconstruction and its norm), so the re-score's norms are its
        reconstruction's."""
        n = codes.shape[0]
        norm_sq = np.empty(n, np.float32)
        for lo in range(0, n, _CHUNK):
            hi = min(lo + _CHUNK, n)
            deq = codes[lo:hi].astype(np.float32) * scales[lo:hi, None]
            if cells is not None:
                deq = deq + self._centroids_host[cells[lo:hi]]
            if codes2 is not None:
                ref = _unpack_nibbles_np(codes2[lo:hi])
                deq = deq + ref.astype(np.float32) * scales2[lo:hi, None]
            norm_sq[lo:hi] = np.einsum("md,md->m", deq, deq)
        return norm_sq

    def _host_arrays(self, codes, scales, labels, ids, cells, codes2,
                     scales2) -> dict:
        """{name: numpy array} of the rows to store, the norms included."""
        out = dict(codes=codes, scales=scales,
                   norm_sq=self._norms_chunked(codes, scales, cells, codes2,
                                               scales2),
                   labels=np.asarray(labels, np.float32),
                   ids=np.asarray(ids, np.int32))
        if cells is not None:
            out["cells"] = np.asarray(cells, np.int32)
        if codes2 is not None:
            out["codes2"], out["scales2"] = codes2, scales2
        return out

    def _install_codes(self, codes: np.ndarray, scales: np.ndarray,
                       labels: np.ndarray, ids: np.ndarray,
                       cells: Optional[np.ndarray] = None,
                       codes2: Optional[np.ndarray] = None,
                       scales2: Optional[np.ndarray] = None) -> None:
        """Install int8 codes as they are (a quantize(dequantize(·)) round
        trip could move codes whose row maximum rounded below 127)."""
        n = codes.shape[0]
        cap = _round_up(max(n, self.capacity_hint))
        for name, arr in self._host_arrays(codes, scales, labels, ids, cells,
                                           codes2, scales2).items():
            fill = -1 if name in ("ids", "cells") else 0
            setattr(self, name, self._padded(arr, cap, fill))
        self.n = n

    def _padded(self, arr: np.ndarray, cap: int, fill) -> torch.Tensor:
        rows = torch.as_tensor(arr, device=self.device)
        out = rows.new_full((cap,) + rows.shape[1:], fill)
        out[: len(rows)] = rows
        return out

    def _append_codes(self, codes: np.ndarray, scales: np.ndarray,
                      labels: np.ndarray, ids: np.ndarray,
                      cells: Optional[np.ndarray] = None,
                      codes2: Optional[np.ndarray] = None,
                      scales2: Optional[np.ndarray] = None) -> None:
        """Append O(new rows): per-row codes are final (the row maximum
        always codes to ±127, so re-quantizing a row reproduces it); the
        capacity grows to a 1,024-row multiple of at least twice itself, or
        the capacity hint, when the rows do not fit."""
        m = codes.shape[0]
        need = self.n + m
        cap = self.codes.shape[0]
        new = self._host_arrays(codes, scales, labels, ids, cells, codes2,
                                scales2)
        if need > cap:
            grown = _round_up(max(need, 2 * cap, self.capacity_hint))
            for name in new:
                old = getattr(self, name)
                fill = -1 if name in ("ids", "cells") else 0
                big = torch.full((grown,) + old.shape[1:], fill,
                                 dtype=old.dtype, device=self.device)
                big[:cap] = old
                setattr(self, name, big)
        for name, arr in new.items():
            getattr(self, name)[self.n:need] = torch.as_tensor(
                arr, device=self.device)
        self.n = need

    # ------------------------------------------------------------------
    def search(self, queries, k: int, *, exclude_ids=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k: → (distances [B, k], row indices [B, k] int64); missing
        slots are index -1 with distance ±inf. ``exclude_ids [B]`` masks
        rows whose id is among the batch's."""
        q = torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                            device=self.device)
        b = q.shape[0]
        if self.n == 0:
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int64))
        if self.metric == "COSINE":
            q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        ex = (torch.full((b,), -2, dtype=torch.int32, device=self.device)
              if exclude_ids is None
              else torch.as_tensor(np.asarray(exclude_ids, np.int32),
                                   device=self.device))
        d, i, _ = _sq8_search(q, self.codes, self.scales, self.norm_sq,
                              self.ids, ex, k, metric=self.metric,
                              n_valid=self.n, accel=self.build_accel,
                              rerank_depth=self.rerank_depth,
                              **self._arrays())
        self.count_search()
        return d.cpu().numpy(), i.cpu().numpy().astype(np.int64)

    def reconstruct_batch(self, indices) -> np.ndarray:
        """Dequantized rows by index as f32; index -1 gives a zero
        vector."""
        idx = torch.as_tensor(np.asarray(indices, np.int64),
                              device=self.device)
        out = _dequantize(idx.clamp_min(0).reshape(-1), self.codes,
                          self.scales, **self._arrays()).reshape(
            idx.shape + (self.dimension,))
        return torch.where((idx >= 0)[..., None], out,
                           torch.zeros_like(out)).cpu().numpy()

    # ------------------------------------------------------------------
    def save(self, directory: str) -> None:
        """The JAX package's files, each written atomically."""
        from radad_tpu_torch.utils.atomic_io import (atomic_json_dump,
                                                     atomic_pickle_dump,
                                                     atomic_savez)

        os.makedirs(directory, exist_ok=True)
        n = self.n
        names = ["codes", "scales", "labels", "ids"]
        if self.centroids is not None:
            names.append("cells")
        if self.codes2 is not None:
            names += ["codes2", "scales2"]
        arrays = {name: getattr(self, name)[:n].cpu().numpy()
                  for name in names}
        if self.centroids is not None:
            arrays["centroids"] = self._centroids_host
        atomic_savez(os.path.join(directory, "sq8_arrays.npz"), **arrays)
        atomic_json_dump({"dimension": self.dimension, "metric": self.metric,
                          "n": n, "residual_nlist": self.residual_nlist,
                          "refine_bits": self.refine_bits},
                         os.path.join(directory, "sq8_meta.json"))
        atomic_pickle_dump({"paths": self.paths, "metadata": self.metadata},
                           os.path.join(directory, "sq8_host.pkl"))

    @classmethod
    def load(cls, directory: str, *, build_accel: bool = True,
             device="cuda") -> "QuantizedIndex":
        with open(os.path.join(directory, "sq8_meta.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(directory, "sq8_arrays.npz"))
        idx = cls(meta["dimension"], meta["metric"], build_accel=build_accel,
                  residual_nlist=int(meta.get("residual_nlist", 0)),
                  refine_bits=int(meta.get("refine_bits", 0)), device=device)
        # sq8_host.pkl is written by this package or the JAX package beside
        # the arrays; it is trusted like the rest of the directory
        with open(os.path.join(directory, "sq8_host.pkl"), "rb") as f:
            host = pickle.load(f)
        idx.paths = list(host["paths"])
        idx.metadata = list(host["metadata"])
        cells = None
        if "centroids" in data:
            idx._centroids_host = np.asarray(data["centroids"], np.float32)
            idx.centroids = torch.as_tensor(idx._centroids_host,
                                            device=idx.device)
            cells = np.asarray(data["cells"], np.int32)
        idx._install_codes(
            data["codes"], data["scales"], data["labels"], data["ids"],
            cells=cells,
            codes2=data["codes2"] if "codes2" in data else None,
            scales2=data["scales2"] if "scales2" in data else None)
        return idx
