"""Device-resident flat vector index with certified-exact search.

Counterpart: ``radad_tpu/index/flat.py`` (``FlatIndex`` for L2, IP,
COSINE and IVF; ``_hier_candidates``, ``_search_fast_exact``,
``_search_device``, ``_rerank_exact``, ``_assign_cells``;
``search_overfetch``, ``reconstruct_batch``, ``labels_for``). The SQ8
index is ``index/quantized.py``.

Search is the JAX package's certified fast-exact route on every device:
one bf16 scan with a hi/lo query split and a bf16 residual term (f32
accumulation), a deep strided-tile candidate select by the rounding-error
upper bound (``ops.topk.extract_candidates``), exact f32 re-scoring of the
top candidates (``ops.rerank.exact_dot``), and a certificate: when some row
that was not re-scored could still beat the k-th exact score, the search
falls back to a full f32 scan. That branch is a host ``if`` on one bool
(``lax.cond`` in JAX); ``FlatIndex.fallbacks`` counts it.

``FlatIndex(build_accel=False)`` builds no scan arrays and searches every
batch with the exact f32 scan alone, as the JAX package's ``build_accel``
does (its meshes consume the canonical arrays). The JAX package also takes
the certified route only where ``_accel_eligible`` holds: on a TPU with D a
multiple of 128, the TPU's lane layout. The port does not build that
layout, so those two conditions are not ported: with ``build_accel`` (the
default) the certified route runs on every device and D.

``FlatIndex(use_pallas=True)`` opts out of it into the JAX package's
single-kernel route: ``ops.topk.flat_topk`` (bf16 fused scan + per-tile
k-select) over-fetches ``max(4k, 32)`` candidates and an exact f32 re-rank
(``_rerank_exact``) orders them. That route is not certified.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values, and
``torch.topk`` leaves their order unspecified on CUDA, so every select
whose ids must match JAX is a stable descending sort, sliced.

IVF (L2 with a k-means coarse quantizer, ``index/ivf.py``): every add
retrains the quantizer on the first 50,000 rows (or, with
``ivf_retrain_on_add=False``, assigns the new rows to the trained cells)
and rebuilds the inverted lists of ``index/ivf_gather.py`` on the host.
A search probes the ``nprobe`` nearest cells of each query (f32, TF32
off, the lower cell first among ties). A small batch, whose probed cells
hold far fewer rows than the index, takes the gather route
(``ivf_gather.py``: only the probed cells' rows are read); any other batch
takes the masked route: the probe mask joins the certified search's mask.
IVF keeps the certified route under ``use_pallas``, as in JAX
(``flat_topk`` has no probe mask).

``FlatIndex.retrieve`` is the pipeline's search: ``retrieve_on_device``
(the search above plus the neighbor rows and labels), or on the predict
paths of an IVF index the chunked gather route under the JAX pipeline's
own gate; it counts every search it runs.

Persistence writes the JAX package's files (``index_arrays.npz``,
``index_meta.json``, ``index_host.pkl``), so an index saved by either
package loads in the other. Paths and metadata stay host-side.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from radad_tpu_torch.index.ivf import kmeans
from radad_tpu_torch.ops.gather import gather_rows
from radad_tpu_torch.ops.rerank import exact_dot
from radad_tpu_torch.ops.topk import (LANES, NEG_INF, extract_candidates,
                                      flat_topk, top_k_stable)
from radad_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_PAD = 1024  # capacity quantum, as in the JAX package
_IVF_TRAIN_ROWS = 50_000  # k-means trains on the first rows (FAISS's cap)
_ASSIGN_ROWS = 131_072  # rows a step of the cell assignment


def _round_up(n: int, m: int = _PAD) -> int:
    return max(m, ((n + m - 1) // m) * m)


def bf16_mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` for bf16 operands with an f32 accumulator and f32
    output. On CUDA ``aten::mm.dtype``; on the CPU (which has no such
    kernel) an f32 product of the upcast operands, the same numbers: bf16
    products are exact in f32."""
    if a.is_cuda:
        return torch.mm(a, b.t(), out_dtype=torch.float32)
    return torch.mm(a.float(), b.float().t())


class FlatIndex:
    """Brute-force (exact) index over clip embeddings, or IVF.

    Device state: ``vectors [cap, D]`` (f32, or bf16 with
    ``use_float16``), ``labels [cap] f32``, ``ids [cap] int32`` (basename
    id per row, for self-exclusion), ``norms_sq [cap] f32``, and the scan
    arrays ``scan_bf16`` / ``resid_bf16`` (None with ``build_accel=False``);
    rows ``>= n`` are masked out of every search. IVF adds ``centroids
    [nlist_effective, D]``, ``cells [cap] int32`` and the inverted lists
    of ``ivf_gather.py`` (``ivf_table`` / ``ivf_overflow``, and
    ``ivf_chunk_rows`` / ``ivf_cell_chunks`` with host copies). Host
    state: paths and metadata lists. ``route`` names the search every
    batch of ``_search_device`` takes: "certified" (the default, and IVF's
    masked route), "full_scan" (``build_accel=False``: the exact f32 scan,
    counted as a search and never as a fallback) or "flat_topk"
    (``use_pallas`` outside IVF: ``flat_topk`` + exact re-rank); IVF's
    gather route is counted apart (``ivf_gather_searches``)."""

    metric_kinds = ("L2", "IP", "COSINE", "IVF")

    def __init__(self, dimension: int, metric: str = "L2", *,
                 nlist: int = 0, nprobe: int = 32, kmeans_iters: int = 25,
                 ivf_balance: float = 0.0, ivf_retrain_on_add: bool = True,
                 use_float16: bool = False, single_buffer: bool = False,
                 add_batch_size: int = 10000, use_pallas: bool = False,
                 build_accel: bool = True, device="cuda"):
        """``single_buffer`` (kept with ``use_float16`` alone, as the JAX
        package keeps it): the JAX package's capacity mode, one device
        buffer of bf16 rows. Port bf16 storage keeps one buffer in any case
        (the scan copy is the stored rows), so the flag changes no array;
        it is saved and loaded with the index.

        IVF knobs, as the JAX package's: ``nlist`` the configured cell
        count (0: 4,096; each training clamps it to its rows and sets
        ``nlist_effective``), ``nprobe`` the cells a search probes,
        ``kmeans_iters`` Lloyd steps, ``ivf_balance`` k-means'
        split-refinement strength, ``ivf_retrain_on_add`` whether an add
        retrains the quantizer (True) or assigns the new rows to the
        trained cells (False, FAISS's ``IndexIVFFlat.add``)."""
        metric = metric.upper()
        if metric not in self.metric_kinds:
            raise ValueError(f"Unknown index metric: {metric}")
        self.dimension = int(dimension)
        self.metric = metric
        self.use_float16 = bool(use_float16)
        self.single_buffer = bool(single_buffer) and self.use_float16
        self.add_batch_size = int(add_batch_size)
        self.use_pallas = use_pallas
        # False: no scan_bf16 / resid_bf16, every search the full f32 scan
        # (the JAX package passes False where a mesh consumes the canonical
        # arrays)
        self.build_accel = bool(build_accel)
        self.device = resolve_device(device)
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.kmeans_iters = int(kmeans_iters)
        self.ivf_balance = float(ivf_balance)
        self.ivf_retrain_on_add = bool(ivf_retrain_on_add)
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
        # IVF state (rows are not reordered: a row's cell is cells[row])
        self.nlist_effective = 0
        self.centroids: Optional[torch.Tensor] = None
        self.cells: Optional[torch.Tensor] = None
        self.ivf_table: Optional[torch.Tensor] = None
        self.ivf_overflow: Optional[torch.Tensor] = None
        self.ivf_chunk_rows: Optional[torch.Tensor] = None
        self.ivf_cell_chunks: Optional[torch.Tensor] = None
        self._ivf_cell_chunks_host: Optional[np.ndarray] = None
        self.ivf_counts: Optional[np.ndarray] = None
        self._chunk_budget_cache: dict = {}  # nprobe -> chunk budget
        self.search_chunk = 2048
        self.searches = 0  # searches run through _search_device
        self.fallbacks = 0  # certified searches that failed the certificate
        self.ivf_gather_searches = 0  # searches on IVF's gather route
        self.ivf_gather_fallbacks = 0  # chunked ones over their budget

    @property
    def ntotal(self) -> int:
        return self.n

    @property
    def route(self) -> str:
        """The search every batch of ``_search_device`` takes: "flat_topk",
        "certified" or "full_scan". IVF never takes "flat_topk"."""
        if self.use_pallas and self.metric != "IVF":
            return "flat_topk"
        return "certified" if self.build_accel else "full_scan"

    # ------------------------------------------------------------------
    def add(self, vectors, labels: Sequence[float], paths: Sequence[str],
            metadata: Optional[Sequence[dict]] = None,
            ids: Optional[Sequence[int]] = None, *,
            donate: bool = False) -> None:
        """Append rows (reference vector_database.py:108-151). ``vectors``
        is a numpy array or a tensor on any device; bf16 rows headed for
        bf16 storage (not COSINE) stay bf16, any other rows go through f32.
        IVF: the first add trains the quantizer on its input rows; a later
        one retrains it on the stored rows, or with
        ``ivf_retrain_on_add=False`` assigns only the new rows (the JAX
        package's ``_install`` / ``add``).

        ``donate=True``: on the first add, a contiguous tensor already on
        the index's device, in the storage dtype, with a multiple of 1,024
        rows becomes the stored rows without a copy (the JAX package's
        zero-copy install; at 1M x 5,376 f32 a copy would hold 21.5 GB
        more). The caller must not write to it afterwards. Any other add
        copies the rows."""
        old_n = self.n
        vec = self._append(vectors, labels, paths, metadata, ids,
                           donate=donate)
        if self.metric != "IVF" or not len(vec):
            return
        if old_n == 0:
            self._train_ivf(vec)
        elif self.centroids is None or self.ivf_retrain_on_add:
            self._train_ivf(self.vectors[: self.n])
        else:
            self._extend_ivf(old_n)

    def _append(self, vectors, labels, paths, metadata, ids,
                donate: bool = False) -> torch.Tensor:
        """Write the rows of an add; → them on the index's device, f32 or
        bf16 as ``add`` takes them (normalized for COSINE)."""
        from radad_tpu_torch.data.manifest import file_id

        vec = torch.as_tensor(vectors)
        store = torch.bfloat16 if self.use_float16 else torch.float32
        # bf16 rows headed for bf16 storage skip the f32 upcast (the JAX
        # package's keep_bf16: 21.5 GB at 1M x 5,376)
        keep_bf16 = (self.use_float16 and self.metric != "COSINE"
                     and vec.dtype == torch.bfloat16)
        vec = vec.to(self.device, vec.dtype if keep_bf16 else torch.float32)
        if vec.dim() != 2 or vec.shape[1] != self.dimension:
            raise ValueError(f"expected [N, {self.dimension}] vectors, got "
                             f"{tuple(vec.shape)}")
        n_new = vec.shape[0]
        if not (len(labels) == len(paths) == n_new):
            raise ValueError("labels/paths length mismatch with vectors")
        if self.metric == "COSINE":
            vec = vec / vec.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        adopt = (donate and self.n == 0 and isinstance(vectors, torch.Tensor)
                 and vec.dtype == store and vec.is_contiguous()
                 and n_new > 0 and n_new % _PAD == 0)
        if ids is None:
            ids = [file_id(p) for p in paths]
        lab = torch.as_tensor(np.asarray(labels, np.float32),
                              device=self.device)
        idc = torch.as_tensor(np.asarray(ids, np.int32), device=self.device)
        self.paths.extend(list(paths))
        self.metadata.extend(list(metadata) if metadata is not None
                             else [{} for _ in range(n_new)])
        need = self.n + n_new
        if adopt:
            self._grow_to(n_new, vectors=vec)
        elif need > self._cap:
            self._grow_to(_round_up(max(need, 2 * self._cap)))
        bs = self.add_batch_size or n_new
        for lo in range(0, n_new, bs):
            hi = min(n_new, lo + bs)
            if not adopt:
                self.vectors[self.n + lo:self.n + hi] = vec[lo:hi]
            self._write_rows(self.n + lo, vec[lo:hi], lab[lo:hi],
                             idc[lo:hi])
        self.n = need
        return vec

    def _grow_to(self, cap: int,
                 vectors: Optional[torch.Tensor] = None) -> None:
        """Reallocate the device arrays at capacity ``cap`` (a multiple
        of 1024), keeping the rows written so far; ``vectors`` (a donated
        first add: ``cap`` rows in the storage dtype) becomes the stored
        rows as it is."""
        dev, d = self.device, self.dimension
        store = torch.bfloat16 if self.use_float16 else torch.float32

        def grown(old, shape, dtype, fill=0):
            new = torch.full(shape, fill, dtype=dtype, device=dev)
            if old is not None:
                new[: old.shape[0]] = old
            return new

        self.vectors = (vectors if vectors is not None
                        else grown(self.vectors, (cap, d), store))
        self.labels = grown(self.labels, (cap,), torch.float32)
        self.ids = grown(self.ids, (cap,), torch.int32, fill=-1)
        self.norms_sq = grown(self.norms_sq, (cap,), torch.float32)
        if self.build_accel and self.use_float16:
            self.scan_bf16 = self.vectors  # bf16 storage IS the scan copy
        elif self.build_accel:
            self.scan_bf16 = grown(self.scan_bf16, (cap, d), torch.bfloat16)
            self.resid_bf16 = grown(self.resid_bf16, (cap, d),
                                    torch.bfloat16)
        if self.cells is not None:
            self.cells = grown(self.cells, (cap,), torch.int32)
        self._cap = cap

    def _write_rows(self, start: int, vec: torch.Tensor, lab: torch.Tensor,
                    idc: torch.Tensor) -> None:
        """The state of rows ``vec`` stored at ``start``: exact norms of the
        stored rows, labels, ids, and (f32 storage, ``build_accel``) their
        bf16 scan copy and bf16 rounding residual, the x-side correction of
        the certified scan."""
        end = start + vec.shape[0]
        stored = self.vectors[start:end].float()
        self.norms_sq[start:end] = stored.square().sum(-1)
        self.labels[start:end] = lab
        self.ids[start:end] = idc
        if self.resid_bf16 is not None:
            hi = vec.to(torch.bfloat16)
            self.scan_bf16[start:end] = hi
            self.resid_bf16[start:end] = (vec - hi.float()).to(
                torch.bfloat16)

    # ------------------------------------------------------------------
    def _train_ivf(self, rows: torch.Tensor) -> None:
        """k-means on the first 50,000 of ``rows`` (FAISS's training cap),
        ``nlist`` (4,096 when 0) clamped to the training rows, seed 0; then
        every stored row assigned to its nearest centroid and the inverted
        lists rebuilt."""
        nlist = self.nlist or 4096
        train = rows[: min(rows.shape[0], _IVF_TRAIN_ROWS)].float()
        if nlist > train.shape[0]:
            logger.info("IVF nlist %d > %d training rows; clamping", nlist,
                        train.shape[0])
            nlist = max(1, train.shape[0])
        self.nlist_effective = nlist
        self.centroids, _ = kmeans(train, nlist, iters=self.kmeans_iters,
                                   seed=0, balance=self.ivf_balance)
        self.cells = torch.zeros((self._cap,), dtype=torch.int32,
                                 device=self.device)
        self._extend_ivf(0)

    def _restore_ivf(self, centroids: np.ndarray, cells: np.ndarray) -> None:
        """Adopt a saved (centroids, cells) pair without k-means (FAISS's
        write_index persists the trained quantizer too)."""
        self.centroids = torch.as_tensor(np.asarray(centroids, np.float32),
                                         device=self.device)
        self.nlist_effective = int(centroids.shape[0])
        self.cells = torch.zeros((self._cap,), dtype=torch.int32,
                                 device=self.device)
        self.cells[: self.n] = torch.as_tensor(
            np.asarray(cells, np.int32)[: self.n], device=self.device)
        self._build_gather_tables()

    def _extend_ivf(self, start: int) -> None:
        """Assign the stored rows ``start:n`` to their nearest trained
        centroid (in chunks: the [N, nlist] distances of 1M rows would be
        16 GB), then rebuild the inverted lists. A training assigns every
        row; with ``ivf_retrain_on_add=False`` an add assigns only its own
        rows (FAISS's ``IndexIVFFlat.add`` never retrains)."""
        for lo in range(start, self.n, _ASSIGN_ROWS):
            hi = min(self.n, lo + _ASSIGN_ROWS)
            self.cells[lo:hi] = _assign_cells(self.vectors[lo:hi],
                                              self.centroids)
        self._build_gather_tables()

    def _build_gather_tables(self) -> None:
        """The span and chunk tables of ``ivf_gather.py``, built on the host
        from the [n] cell ids (4 MB at 1M rows) and uploaded. The chunk
        width is the largest power of two from 8 to 128 that is <= the mean
        cell (128 at 1M rows and nlist 4,096; 8 on small indexes, where 128
        would make budget x chunk fail the gather gate, 2 touched < n)."""
        from radad_tpu_torch.index.ivf_gather import (build_cell_table,
                                                      build_chunk_table)

        cells = self.cells[: self.n].cpu().numpy()
        nlist, dev = self.nlist_effective, self.device
        table, _, overflow = build_cell_table(cells, self.n, nlist)
        self.ivf_table = torch.as_tensor(table, device=dev)
        self.ivf_overflow = torch.as_tensor(overflow, device=dev)
        self._chunk_budget_cache = {}
        mean_cell = max(1.0, self.n / max(1, nlist))
        chunk = 8
        while chunk * 2 <= min(128, mean_cell):
            chunk *= 2
        chunk_rows, cell_chunks, counts = build_chunk_table(
            cells, self.n, nlist, chunk=chunk)
        self.ivf_chunk_rows = torch.as_tensor(chunk_rows, device=dev)
        self.ivf_cell_chunks = torch.as_tensor(cell_chunks, device=dev)
        self._ivf_cell_chunks_host = cell_chunks
        self.ivf_counts = counts

    def chunk_budget(self, np_eff: int) -> int:
        """The chunked gather's budget at ``np_eff`` probes, from the host
        tables (never a device read per call), cached."""
        from radad_tpu_torch.index.ivf_gather import default_chunk_budget

        budget = self._chunk_budget_cache.get(np_eff)
        if budget is None:
            budget = default_chunk_budget(self._ivf_cell_chunks_host,
                                          self.ivf_counts, np_eff)
            self._chunk_budget_cache[np_eff] = budget
        return budget

    # ------------------------------------------------------------------
    def search(self, queries, k: int, *, exclude_ids=None,
               nprobe: Optional[int] = None, gather: Optional[bool] = None,
               _ids=None, _exclude_mode: str = "batch"
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k: → (distances [B, k], row indices [B, k] int64). Missing
        slots (k > matches) are index -1 with distance +inf (L2, IVF) or
        -inf (IP/COSINE). ``exclude_ids [B]`` masks rows whose stored id is
        in the batch's set (the reference's batch-global self-filter,
        pipeline.py:461-463,494-501).

        IVF: ``nprobe`` overrides the index's for this call (the
        reference's per-search ``index.nprobe``, vector_database.py:
        175-179). ``gather`` forces the gather route (True) or the masked
        route (False); None picks the gather route when the rows it
        touches, B (nprobe span + overflow) or B budget chunk, whichever
        is fewer, are under half the index, and then the table that
        touches fewer."""
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        b = q.shape[0]
        if self.n == 0:
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int64))
        if b > self.search_chunk:
            # one call-global exclusion union, folded into the id column
            # once (the -3 sentinel), then chunks in "self" mode; the tail
            # chunk is padded to search_chunk rows, as the JAX package's
            # fixed-shape chunks are, so IVF's gather gate sees the same B
            cs = self.search_chunk
            ids_use, ex_chunk = None, None
            if exclude_ids is not None:
                ex = torch.as_tensor(np.asarray(exclude_ids, np.int32),
                                     device=self.device)
                ids_use = torch.where(torch.isin(self.ids, ex),
                                      torch.full_like(self.ids, -3),
                                      self.ids)
                ex_chunk = np.full((cs,), -3, np.int32)
            dd, ii = [], []
            for lo in range(0, b, cs):
                qc = q[lo:lo + cs]
                rows = qc.shape[0]
                if rows < cs:
                    qc = torch.nn.functional.pad(qc, (0, 0, 0, cs - rows))
                d, i = self.search(qc, k, exclude_ids=ex_chunk,
                                   nprobe=nprobe, gather=gather,
                                   _ids=ids_use, _exclude_mode="self")
                dd.append(d[:rows])
                ii.append(i[:rows])
            return np.concatenate(dd), np.concatenate(ii)
        if self.metric == "COSINE":
            q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        if exclude_ids is None:
            ex = torch.full((b,), -2, dtype=torch.int32, device=self.device)
        else:
            ex = torch.as_tensor(np.asarray(exclude_ids, np.int32),
                                 device=self.device)
        ids = self.ids if _ids is None else _ids
        np_req = self.nprobe if nprobe is None else int(nprobe)
        if self.metric == "IVF" and self.ivf_table is not None:
            out = self._gather_search(q, ids, ex, k, np_req, gather,
                                      _exclude_mode)
            if out is not None:
                return out
        ivf = self.metric == "IVF"
        dists, idx, fell_back = _search_device(
            q, self.vectors, ids, ex, k, metric=self.metric, n_valid=self.n,
            xsq=self.norms_sq, scan_bf16=self.scan_bf16,
            resid_bf16=self.resid_bf16, exclude_mode=_exclude_mode,
            use_pallas=self.use_pallas,
            centroids=self.centroids if ivf else None,
            cells=self.cells if ivf else None, nprobe=np_req)
        self.count_search(fell_back)
        return dists.cpu().numpy(), idx.cpu().numpy().astype(np.int64)

    def _gather_search(self, q, ids, ex, k, nprobe, gather, exclude_mode):
        """IVF's gather route where ``search`` takes it (JAX
        ``flat.py:599-628``), else None."""
        from radad_tpu_torch.index.ivf_gather import (
            ivf_gather_search, ivf_gather_search_chunked)

        b = q.shape[0]
        np_eff = min(nprobe, self.ivf_table.shape[0])
        # the overflow rides along with every query: B V rows, not V
        touched_span = b * (np_eff * self.ivf_table.shape[1]
                            + self.ivf_overflow.shape[0])
        budget = self.chunk_budget(np_eff)
        touched_chunk = b * budget * self.ivf_chunk_rows.shape[1]
        if not (gather or (gather is None
                           and 2 * min(touched_span, touched_chunk) < self.n)):
            return None
        fell_back = False
        if touched_chunk <= touched_span:
            dists, idx, fell_back = ivf_gather_search_chunked(
                q, self.vectors, self.norms_sq, ids, ex, self.centroids,
                self.ivf_chunk_rows, self.ivf_cell_chunks, self.cells, k,
                nprobe=np_eff, budget=budget, n_valid=self.n,
                exclude_mode=exclude_mode)
        else:
            dists, idx = ivf_gather_search(
                q, self.vectors, self.norms_sq, ids, ex, self.centroids,
                self.ivf_table, self.ivf_overflow, k, nprobe=np_eff,
                exclude_mode=exclude_mode)
        self.count_gather_search(fell_back)
        return dists.cpu().numpy(), idx.cpu().numpy().astype(np.int64)

    def retrieve(self, tpp, exclude_ids, *, k: int,
                 exclude_mode: str = "batch", serving: bool = False):
        """Search + neighbors on the device, counted → (neighbors [B, k, D]
        f32, labels [B, k], dists [B, k], idx [B, k]), as the JAX package's
        single-device dispatch (``radad_tpu/train/pipeline.py:660-689``).
        IVF with ``serving`` (the predict paths) takes the chunked gather
        route when 2 B budget chunk < n; everything else (train, eval,
        larger predict batches) is ``retrieve_on_device`` without the
        centroids: the search over every row, unprobed."""
        if (serving and self.metric == "IVF"
                and self.ivf_chunk_rows is not None):
            from radad_tpu_torch.index.ivf_gather import (
                retrieve_on_device_ivf_gather_chunked)

            nprobe = min(self.nprobe, self.ivf_cell_chunks.shape[0])
            budget = self.chunk_budget(nprobe)
            if 2 * tpp.shape[0] * budget * self.ivf_chunk_rows.shape[1] \
                    < self.n:
                *out, fell_back = retrieve_on_device_ivf_gather_chunked(
                    tpp, self.vectors, self.norms_sq, self.labels, self.ids,
                    exclude_ids, self.centroids, self.ivf_chunk_rows,
                    self.ivf_cell_chunks, self.cells, k=k, nprobe=nprobe,
                    budget=budget, n_valid=self.n, exclude_mode=exclude_mode)
                self.count_gather_search(fell_back)
                return tuple(out)
        *out, fell_back = retrieve_on_device(
            tpp, self.vectors, self.labels, self.ids, exclude_ids, k=k,
            metric=self.metric, n_valid=self.n, xsq=self.norms_sq,
            scan_bf16=self.scan_bf16, resid_bf16=self.resid_bf16,
            exclude_mode=exclude_mode, use_pallas=self.use_pallas)
        self.count_search(fell_back)
        return tuple(out)

    def count_search(self, fell_back: bool) -> None:
        self.searches += 1
        self.fallbacks += int(fell_back)

    def count_gather_search(self, fell_back: bool) -> None:
        self.ivf_gather_searches += 1
        self.ivf_gather_fallbacks += int(fell_back)

    def search_overfetch(self, queries, k: int, exclude_basenames=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Reference-parity retrieval (reference pipeline.py:478-515):
        over-fetch k + 10, drop rows whose file basename is excluded on the
        host, truncate / pad to k. It exists to hold the device-side masked
        search (the production path) to the reference's semantics."""
        exclude = set(exclude_basenames or ())
        k_search = min(k + (10 if exclude else 0), max(self.n, 1))
        dists, idxs = self.search(queries, k_search)
        b = dists.shape[0]
        out_d = np.full((b, k), np.inf, np.float32)
        out_i = np.full((b, k), -1, np.int64)
        for row in range(b):
            kept = 0
            for dd, ii in zip(dists[row], idxs[row]):
                if ii < 0 or (exclude and os.path.basename(
                        self.paths[int(ii)]) in exclude):
                    continue
                out_d[row, kept] = dd
                out_i[row, kept] = ii
                kept += 1
                if kept == k:
                    break
        return out_d, out_i

    def reconstruct_batch(self, indices) -> np.ndarray:
        """Stored rows by index as f32 (a gather, where the reference loops
        over ``index.reconstruct``, pipeline.py:503); index -1 gives a zero
        vector."""
        idx = torch.as_tensor(np.asarray(indices, np.int64),
                              device=self.device)
        out = self.vectors[idx.clamp_min(0).reshape(-1)].float().reshape(
            idx.shape + (self.dimension,))
        return torch.where((idx >= 0)[..., None], out,
                           torch.zeros_like(out)).cpu().numpy()

    def labels_for(self, indices) -> np.ndarray:
        """Stored labels by index; index -1 gives 0."""
        idx = np.asarray(indices)
        lab = self.labels.cpu().numpy()[np.maximum(idx, 0).reshape(-1)
                                        ].reshape(idx.shape)
        return np.where(idx >= 0, lab, 0.0).astype(np.float32)

    # ------------------------------------------------------------------
    def save(self, directory: str) -> None:
        """The JAX package's files, each written atomically; an IVF index
        adds its trained ``centroids`` and the rows' ``cells``."""
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
        if self.centroids is not None:
            arrays["centroids"] = self.centroids.cpu().numpy()
            arrays["cells"] = self.cells[:n].cpu().numpy()
        atomic_savez(os.path.join(directory, "index_arrays.npz"), **arrays)
        meta = dict(dimension=self.dimension, metric=self.metric, n=n,
                    nlist=self.nlist, nprobe=self.nprobe,
                    use_float16=self.use_float16,
                    single_buffer=self.single_buffer,
                    kmeans_iters=self.kmeans_iters,
                    ivf_balance=self.ivf_balance,
                    ivf_retrain_on_add=self.ivf_retrain_on_add)
        atomic_json_dump(meta, os.path.join(directory, "index_meta.json"))
        atomic_pickle_dump({"paths": self.paths, "metadata": self.metadata},
                           os.path.join(directory, "index_host.pkl"))

    @classmethod
    def load(cls, directory: str, *, use_pallas: bool = False,
             build_accel: bool = True, device="cuda") -> "FlatIndex":
        """An index saved by either package; IVF's quantizer is restored
        from the files, not trained again."""
        with open(os.path.join(directory, "index_meta.json")) as f:
            meta = json.load(f)
        idx = cls(meta["dimension"], meta["metric"],
                  nlist=meta.get("nlist", 0), nprobe=meta.get("nprobe", 32),
                  kmeans_iters=int(meta.get("kmeans_iters", 25)),
                  ivf_balance=float(meta.get("ivf_balance", 0.0)),
                  ivf_retrain_on_add=bool(meta.get("ivf_retrain_on_add",
                                                   True)),
                  use_float16=meta.get("use_float16", False),
                  single_buffer=meta.get("single_buffer", False),
                  use_pallas=use_pallas, build_accel=build_accel,
                  device=device)
        data = np.load(os.path.join(directory, "index_arrays.npz"))
        # index_host.pkl is written by this package or the JAX package
        # beside the arrays; it is trusted like the rest of the directory
        with open(os.path.join(directory, "index_host.pkl"), "rb") as f:
            host = pickle.load(f)
        vectors = data["vectors"]
        if not len(vectors):
            return idx
        rows = (vectors, data["labels"].tolist(), list(host["paths"]),
                list(host["metadata"]), data["ids"].tolist())
        if "centroids" in data and "cells" in data:
            idx._append(*rows)
            idx._restore_ivf(data["centroids"], data["cells"])
        else:
            idx.add(*rows)
        return idx


# ----------------------------------------------------------------------
def _assign_cells(vectors: torch.Tensor,
                  centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row → [N] int32, in exact f32 (TF32 off;
    FAISS assigns in f32 too), the lower cell on ties."""
    v = vectors.float()
    d = (v.square().sum(-1, keepdim=True) - 2.0 * (v @ centroids.t())
         + centroids.square().sum(-1)[None, :])
    return d.argmin(-1).to(torch.int32)


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


def _rerank_exact(q, vectors, cand_scores, cand_idx, k, larger_better):
    """Exact f32 re-rank of R candidates (JAX ``_rerank_exact`` as the
    ``use_pallas`` route calls it): gather the rows (``gather_rows``), f32
    dots (TF32 off), ``|x|^2`` from the gathered rows, stable top-k.
    Candidates with a non-finite scan score stay out. → (dists [B, k],
    idx [B, k] int32)."""
    b, r = cand_idx.shape
    safe = cand_idx.clamp_min(0).to(torch.int32)
    cand = gather_rows(vectors, safe.reshape(-1)).float().reshape(
        b, r, vectors.shape[-1])
    qf = q.float()
    qc = torch.bmm(cand, qf[:, :, None])[..., 0]  # [B, R]
    if larger_better:
        exact = qc
    else:
        exact = -(qf.square().sum(-1, keepdim=True) - 2.0 * qc
                  + cand.square().sum(-1))
    exact = exact.masked_fill(~torch.isfinite(cand_scores), NEG_INF)
    top_scores, pos = top_k_stable(exact, k)
    top_idx = cand_idx.gather(1, pos)
    valid = torch.isfinite(top_scores)
    miss = NEG_INF if larger_better else float("inf")
    dists = torch.where(valid, top_scores if larger_better else -top_scores,
                        torch.full_like(top_scores, miss))
    idx = torch.where(valid, top_idx, torch.full_like(top_idx, -1))
    return dists, idx.to(torch.int32)


def fold_exclusion(ids, exclude_ids, b: int, exclude_mode: str):
    """``exclude_mode="batch"``: ONE exclusion set from the whole query
    batch's ids (reference parity, pipeline.py:461-463): every excluded
    row's id becomes the -3 sentinel that each of the ``b`` queries
    excludes, so the set's length need not be ``b``. ``"self"``: each query
    excludes its own id. → (ids, exclude_ids [b])."""
    if exclude_mode != "batch":
        return ids, exclude_ids
    ids = torch.where(torch.isin(ids, exclude_ids), torch.full_like(ids, -3),
                      ids)
    return ids, torch.full((b,), -3, dtype=torch.int32, device=ids.device)


def probe_cells(q: torch.Tensor, centroids: torch.Tensor,
                nprobe: int) -> torch.Tensor:
    """IVF's coarse probe: the ``nprobe`` nearest centroids of each query by
    |q|^2 - 2 q.c + |c|^2 in f32 (TF32 off: JAX's HIGHEST, FAISS's exact
    f32), the lower cell first among equal values. → [B, nprobe]."""
    qc = (q.square().sum(-1, keepdim=True) - 2.0 * (q @ centroids.t())
          + centroids.square().sum(-1)[None, :])
    return top_k_stable(-qc, min(int(nprobe), centroids.shape[0]))[1]


def probe_mask(probe: torch.Tensor, cells: torch.Tensor,
               nlist: int) -> torch.Tensor:
    """[B, cap] True where a row's cell is among its query's probed cells:
    a [B, nlist] membership scatter, then a per-row gather (cell ids
    clamped into range, as ``jnp.take(mode="clip")``)."""
    member = torch.zeros((probe.shape[0], nlist), dtype=torch.bool,
                         device=probe.device)
    member.scatter_(1, probe, True)
    return member.index_select(1, cells.long().clamp(0, nlist - 1))


def _search_device(q, vectors, ids, exclude_ids, k, *, metric, n_valid, xsq,
                   scan_bf16, resid_bf16=None, exclude_mode="batch",
                   rerank_depth=None, use_pallas=False, centroids=None,
                   cells=None, nprobe=32):
    """Score + mask + k-select. → (dists [B, k], idx [B, k] int32,
    fell_back).

    Default: the certified search, ``fell_back`` when it ran the full f32
    scan; without ``scan_bf16`` (``FlatIndex(build_accel=False)``) the full
    f32 scan alone, ``fell_back`` False. ``use_pallas`` (not IVF):
    ``flat_topk`` over-fetches ``max(4k, 32)`` candidates from a bf16 scan,
    ``_rerank_exact`` orders them (JAX ``flat.py:1216-1224``, ``|x|^2``
    from the gathered rows as there); ``fell_back`` is False.

    IVF (L2) with ``centroids``: rows outside each query's ``nprobe``
    probed cells are masked (``probe_cells``, ``probe_mask``), and the
    probe mask joins the certified search's mask (JAX
    ``flat.py:1172-1213``); IVF keeps that route under ``use_pallas``.
    IVF without ``centroids`` searches every row (the pipeline's
    unprobed retrieval).

    ``exclude_mode``: see ``fold_exclusion``."""
    ids, exclude_ids = fold_exclusion(ids, exclude_ids, q.shape[0],
                                      exclude_mode)
    cap = vectors.shape[0]
    larger_better = metric in ("IP", "COSINE")
    if use_pallas and metric != "IVF":
        r = min(max(4 * k, 32), cap)
        cand_scores, cand_idx = flat_topk(
            q.float().contiguous(), vectors, r, metric=metric,
            n_valid=n_valid, ids=ids, exclude_ids=exclude_ids,
            fast_scan=True)
        dists, idx = _rerank_exact(q, vectors, cand_scores, cand_idx, k,
                                   larger_better)
        return dists, idx, False
    invalid_row = torch.arange(cap, device=q.device) >= n_valid
    mask = invalid_row[None, :] | (ids[None, :] == exclude_ids[:, None])
    if metric == "IVF" and centroids is not None:
        mask = mask | ~probe_mask(probe_cells(q, centroids, nprobe), cells,
                                  centroids.shape[0])
    if scan_bf16 is None:
        dists, idx = _full_scan(q, vectors, xsq, mask, k, larger_better)
        return dists, idx, False
    dists, idx, certified = _search_fast_exact(
        q, scan_bf16, xsq, mask, k, larger_better, vectors,
        resid_bf16=resid_bf16, rerank_depth=rerank_depth)
    if certified:
        return dists, idx, False
    dists, idx = _full_scan(q, vectors, xsq, mask, k, larger_better)
    return dists, idx, True


def retrieve_on_device(tpp, vectors, labels, ids, exclude_ids, *, k, metric,
                       n_valid, xsq, scan_bf16, resid_bf16=None,
                       exclude_mode="batch", use_pallas=False):
    """Search (certified, or ``flat_topk`` + re-rank with ``use_pallas``) +
    neighbor/label gather (JAX ``train/pipeline.py::retrieve_on_device``).
    → (neighbors [B, k, D] f32, labels [B, k], dists [B, k], idx [B, k],
    fell_back). Missing neighbors are zero vectors with label 0 and index
    -1 (reference pipeline.py:511-515)."""
    q = tpp
    if metric == "COSINE":
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    dists, idx, fell_back = _search_device(
        q, vectors, ids, exclude_ids, k, metric=metric, n_valid=n_valid,
        xsq=xsq, scan_bf16=scan_bf16, resid_bf16=resid_bf16,
        exclude_mode=exclude_mode, use_pallas=use_pallas)
    safe = idx.clamp_min(0).to(torch.int32)
    d = vectors.shape[-1]
    neighbors = gather_rows(vectors, safe.reshape(-1)).float()
    neighbors = neighbors.reshape(idx.shape + (d,))
    ok = idx >= 0
    neighbors = torch.where(ok[..., None], neighbors,
                            torch.zeros_like(neighbors))
    nlabels = torch.where(ok, labels[safe.long()], torch.zeros_like(dists))
    return neighbors, nlabels, dists, idx, fell_back
