"""Row-sharded retrieval over the mesh's 'index' axis.

Counterpart: ``radad_tpu/parallel/sharded_index.py`` (``ShardedRetrieval``,
``sharded_retrieve``, ``sharded_retrieve_sq8``,
``sharded_retrieve_ivf_gather``, ``build_sharded_chunk_tables``,
``ShardedIndex``).

The DB rows are split over the 'index' axis: each rank scans only its own
block (an f32 product with TF32 off, as JAX's HIGHEST, then a top-k), and
each shard's candidates (score, global row id, neighbor vector, label) are
all-gathered over the index group and re-selected. JAX runs this inside
``shard_map``; here every function takes the rank's local tensors and a
``Mesh`` and runs on each rank:

* ``q`` and ``exclude_ids`` are the rank's slice of the batch (split over
  'data', replicated over 'index');
* the row arrays are the rank's block (the capacity padded by
  ``shard_capacity``), and a shard's global row id is
  ``shard * rows_per_shard + local row``;
* replicated arrays (IVF and residual-SQ8 centroids) are whole on every
  rank.

The merge lays the gathered candidates out as JAX's transpose does,
``[b, S * k]`` in shard order, and selects with ``top_k_stable`` (the lower
position first among ties, as ``lax.top_k``), so a query's ids match the
one-device exact scan's. No Pallas kernel runs on the mesh in JAX (its
pipeline builds no accelerator arrays there), so none of the port's CUDA
kernels runs here either.

Collectives: "batch" exclusion all-gathers the exclusion ids over 'data'
(one call); "self" needs none; the merge all-gathers four tensors over
'index'. The gather-probed IVF search decides per rank whether its probed
chunks fit the budget (JAX's ``lax.cond``, here a host ``if``); the ranks
may decide differently, so no collective sits inside either branch: the
exclusion gather comes before it and the merge after it.

Beside each sharded search, ``plain_*`` runs the same search in one process
on one device: a loop over the S row blocks and the same merge. It holds a
multi-rank run (tests, ``chip_smoke.py``); the pipeline never calls it.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from radad_tpu_torch.index.flat import probe_cells, probe_mask
from radad_tpu_torch.index.ivf_gather import (build_chunk_table,
                                              default_chunk_budget,
                                              ivf_gather_search_chunked)
from radad_tpu_torch.index.quantized import (QuantizedIndex, _dequantize,
                                             int8_scan)
from radad_tpu_torch.ops.topk import NEG_INF, top_k_stable
from radad_tpu_torch.parallel.mesh import (DATA_AXIS, INDEX_AXIS, Mesh,
                                           index_sharding)


class ShardedRetrieval(NamedTuple):
    neighbors: torch.Tensor  # [b, k, D] f32
    labels: torch.Tensor  # [b, k]
    dists: torch.Tensor  # [b, k] (+inf, or -inf for IP/COSINE, on missing)
    indices: torch.Tensor  # [b, k] int32 global row ids (-1 on missing)


def _local_scores(q, vectors, metric, xsq=None):
    """Scores of ``q [b, D]`` against a shard's rows, f32 (TF32 off: JAX's
    HIGHEST); L2 as -(|q|^2 - 2 q.x + |x|^2), ``xsq`` the rows' |x|^2."""
    qf = q.float()
    qx = qf @ vectors.float().t()
    if metric in ("IP", "COSINE"):
        return qx
    if xsq is None:
        xsq = vectors.float().square().sum(-1)
    return -(qf.square().sum(-1, keepdim=True) - 2.0 * qx + xsq[None, :])


def _top_k(scores, k):
    """``top_k_stable`` padded to k with (-inf, 0) where a shard has fewer
    than k columns (``lax.top_k`` needs k <= columns)."""
    vals, idx = top_k_stable(scores, min(k, scores.shape[-1]))
    if vals.shape[-1] < k:
        pad = k - vals.shape[-1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, pad), value=0)
    return vals, idx


def _candidates(vals, loc_idx, offset: int, rows, lab_loc):
    """One shard's candidates → (vals [b, k], global ids [b, k] int32,
    rows [b, k, D] f32, labels [b, k]): ``rows`` are the candidate rows,
    ``offset`` the shard's first global row; a slot without a finite score
    has id -1, a zero row and label 0."""
    ok = torch.isfinite(vals)
    gidx = torch.where(ok, loc_idx + offset,
                       torch.full_like(loc_idx, -1)).to(torch.int32)
    vecs = torch.where(ok[..., None], rows.float(),
                       torch.zeros((), device=vals.device))
    labs = torch.where(ok, lab_loc[loc_idx.clamp_min(0).long()].float(),
                       torch.zeros_like(vals))
    return vals, gidx, vecs, labs


def merge_candidates(g_vals, g_idx, g_vecs, g_labs, k: int,
                     metric: str) -> ShardedRetrieval:
    """The global top-k of every shard's candidates ``[S, b, k, ...]``,
    laid out ``[b, S * k]`` in shard order and selected lower position
    first among ties; a slot without a finite score is (±inf, -1)."""
    s, b = g_vals.shape[:2]
    d = g_vecs.shape[-1]
    flat_vals = g_vals.permute(1, 0, 2).reshape(b, s * k)
    flat_idx = g_idx.permute(1, 0, 2).reshape(b, s * k)
    flat_vecs = g_vecs.permute(1, 0, 2, 3).reshape(b, s * k, d)
    flat_labs = g_labs.permute(1, 0, 2).reshape(b, s * k)
    top, pos = top_k_stable(flat_vals, k)
    vecs = flat_vecs.gather(1, pos[..., None].expand(-1, -1, d))
    ok = torch.isfinite(top)
    l2 = metric not in ("IP", "COSINE")
    miss = float("inf") if l2 else NEG_INF
    dists = torch.where(ok, -top if l2 else top, torch.full_like(top, miss))
    idx = flat_idx.gather(1, pos)
    return ShardedRetrieval(vecs, flat_labs.gather(1, pos), dists,
                            torch.where(ok, idx, torch.full_like(idx, -1)))


def _merge_shard_candidates(mesh: Mesh, cands, k: int,
                            metric: str) -> ShardedRetrieval:
    """The merge on the mesh: each of the four candidate tensors
    all-gathered over 'index' (four calls), then ``merge_candidates``."""
    return merge_candidates(*(mesh.all_gather(t, INDEX_AXIS) for t in cands),
                            k, metric)


def _plain_merge(shards: int, per_shard: Callable, k: int,
                 metric: str) -> ShardedRetrieval:
    """The plain form's merge: ``per_shard(i)`` (a shard's four candidate
    tensors) for each row block, stacked in shard order."""
    outs = [per_shard(i) for i in range(shards)]
    return merge_candidates(*(torch.stack(t) for t in zip(*outs)), k,
                            metric)


def _exclusion(mesh: Mesh, exclude_ids, exclude_mode: str):
    """The ids a shard excludes: "self", each query's own (no collective);
    "batch", every id of the global batch (one all-gather over 'data';
    the reference's batch-wide set, pipeline.py:461-463)."""
    if exclude_mode == "self":
        return exclude_ids
    return mesh.all_gather(exclude_ids, DATA_AXIS).reshape(-1)


def _blocks(shards: int, *arrays) -> List[tuple]:
    """Each array's ``shards`` row blocks (None stays None)."""
    cap = arrays[0].shape[0]
    if cap % shards:
        raise ValueError(f"capacity {cap} is not divisible by {shards} "
                         f"shards")
    return [a.chunk(shards) if a is not None else (None,) * shards
            for a in arrays]


def _row_mask(ids_loc, valid_loc, excl, exclude_mode: str):
    """Rows a query may not return: invalid, or excluded ("self": its own
    id; "batch": any id of ``excl``). → [b, rows] or [1, rows]."""
    if exclude_mode == "self":
        return (~valid_loc)[None, :] | (ids_loc[None, :] == excl[:, None])
    return ((~valid_loc) | torch.isin(ids_loc, excl))[None, :]


# ----------------------------------------------------------------------
def _flat_shard(q, v_loc, lab_loc, ids_loc, valid_loc, excl, shard, *, k,
                metric, centroids, cells_loc, nprobe, exclude_mode,
                xsq=None):
    """One shard's exact (IVF: probed) top-k candidates."""
    scores = _local_scores(q, v_loc, metric, xsq)
    mask = _row_mask(ids_loc, valid_loc, excl, exclude_mode)
    if centroids is not None:
        # the replicated centroids: every shard masks the same cells
        mask = mask | ~probe_mask(probe_cells(q.float(), centroids, nprobe),
                                  cells_loc, centroids.shape[0])
    vals, loc = _top_k(scores.masked_fill(mask, NEG_INF), k)
    rows = v_loc[loc.reshape(-1)].reshape(loc.shape + (v_loc.shape[1],))
    return _candidates(vals, loc, shard * v_loc.shape[0], rows, lab_loc)


def sharded_retrieve(mesh: Mesh, q, vectors, labels, ids, row_valid,
                     exclude_ids, *, k: int, metric: str = "L2",
                     centroids=None, cells=None, nprobe: int = 32,
                     exclude_mode: str = "batch",
                     xsq=None) -> ShardedRetrieval:
    """Exact top-k over the sharded rows. ``q [b, D]`` and ``exclude_ids
    [b]`` are the rank's batch slice; ``vectors``, ``labels``, ``ids``,
    ``row_valid`` (and ``cells``; ``xsq``, the rows' |x|^2, computed when
    None) its row block. With ``centroids`` (replicated) each query keeps
    the rows of its ``nprobe`` nearest cells (IVF): the one-device masked
    route's candidate set. → this rank's queries' results, the same on
    every rank of its index group."""
    excl = _exclusion(mesh, exclude_ids, exclude_mode)
    cands = _flat_shard(
        q, vectors, labels, ids, row_valid, excl, mesh.coord(INDEX_AXIS),
        k=k, metric=metric, centroids=centroids, cells_loc=cells,
        nprobe=nprobe, exclude_mode=exclude_mode, xsq=xsq)
    return _merge_shard_candidates(mesh, cands, k, metric)


def plain_sharded_retrieve(q, vectors, labels, ids, row_valid, exclude_ids,
                           *, shards: int, k: int, metric: str = "L2",
                           centroids=None, cells=None, nprobe: int = 32,
                           exclude_mode: str = "batch") -> ShardedRetrieval:
    """``sharded_retrieve`` in one process over the whole batch and the
    whole capacity-padded table, as ``shards`` row blocks."""
    vb, lb, ib, rb, cb = _blocks(shards, vectors, labels, ids, row_valid,
                                 cells)
    return _plain_merge(shards, lambda i: _flat_shard(
        q, vb[i], lb[i], ib[i], rb[i], exclude_ids, i, k=k, metric=metric,
        centroids=centroids, cells_loc=cb[i], nprobe=nprobe,
        exclude_mode=exclude_mode), k, metric)


# ----------------------------------------------------------------------
def _sq8_shard(q, c_loc, s_loc, nsq_loc, lab_loc, ids_loc, excl, shard, *,
               k, metric, centroids, cells_loc, exclude_mode):
    """One shard's SQ8 candidates: the int8 scan (the query quantized alike
    on every shard), the shard's top-R by quantized score, R = min(max(4k,
    32), rows), the f32 re-score of their dequantized rows against the
    unquantized query, the shard's top-k."""
    rows, d = c_loc.shape
    larger_better = metric in ("IP", "COSINE")
    q = q.float().contiguous()
    q_scale = (q.abs().amax(-1) / 127.0).clamp_min(1e-12)
    q8 = torch.clamp(torch.round(q / q_scale[:, None]), -127, 127
                     ).to(torch.int8)
    qx = int8_scan(q8, c_loc).float() * (q_scale[:, None] * s_loc[None, :])
    if centroids is not None:
        # residual mode: + the exact f32 q.c_cell of each row's cell
        qx = qx + (q @ centroids.t())[:, cells_loc.clamp_min(0).long()]
    qsq = q.square().sum(-1, keepdim=True)
    scores = qx if larger_better else -(qsq - 2.0 * qx + nsq_loc[None, :])
    scores = scores.masked_fill(
        _row_mask(ids_loc, ids_loc >= 0, excl, exclude_mode), NEG_INF)
    r = min(max(4 * k, 32), rows)
    cand_scores, cand_idx = top_k_stable(scores, r)
    cand = _dequantize(cand_idx.reshape(-1), c_loc, s_loc, centroids,
                       cells_loc).reshape(cand_idx.shape + (d,))
    qc = torch.bmm(cand, q[:, :, None])[..., 0]
    exact = qc if larger_better else -(qsq - 2.0 * qc + nsq_loc[cand_idx])
    exact = exact.masked_fill(~torch.isfinite(cand_scores), NEG_INF)
    vals, pos = _top_k(exact, k)
    loc = cand_idx.gather(1, pos)
    picked = cand.gather(1, pos[..., None].expand(-1, -1, d))
    return _candidates(vals, loc, shard * rows, picked, lab_loc)


def sharded_retrieve_sq8(mesh: Mesh, q, codes, scales, norm_sq, labels, ids,
                         exclude_ids, *, k: int, metric: str = "L2",
                         centroids=None, cells=None,
                         exclude_mode: str = "batch") -> ShardedRetrieval:
    """int8 retrieval over the sharded rows: each shard's int8 scan and f32
    re-score of its top-R quantized candidates, then the flat merge. Exact
    with respect to the stored (dequantized) rows among each shard's pool;
    the pool depends on the number of shards. Row validity is ``ids >= 0``.
    ``centroids`` (replicated) / ``cells`` (with the rows): residual SQ8
    (x̂ = c_cell + s · codes)."""
    excl = _exclusion(mesh, exclude_ids, exclude_mode)
    cands = _sq8_shard(q, codes, scales, norm_sq, labels, ids, excl,
                       mesh.coord(INDEX_AXIS), k=k, metric=metric,
                       centroids=centroids, cells_loc=cells,
                       exclude_mode=exclude_mode)
    return _merge_shard_candidates(mesh, cands, k, metric)


def plain_sharded_retrieve_sq8(q, codes, scales, norm_sq, labels, ids,
                               exclude_ids, *, shards: int, k: int,
                               metric: str = "L2", centroids=None,
                               cells=None, exclude_mode: str = "batch"
                               ) -> ShardedRetrieval:
    """``sharded_retrieve_sq8`` in one process, ``shards`` row blocks."""
    blocks = _blocks(shards, codes, scales, norm_sq, labels, ids, cells)
    return _plain_merge(shards, lambda i: _sq8_shard(
        q, *(b[i] for b in blocks[:5]), exclude_ids, i, k=k, metric=metric,
        centroids=centroids, cells_loc=blocks[5][i],
        exclude_mode=exclude_mode), k, metric)


# ----------------------------------------------------------------------
def _gather_shard(q, v_loc, lab_loc, ids_loc, excl, centroids, cells_loc,
                  cr_loc, cc_loc, n_valid: int, shard, *, k, nprobe, budget,
                  exclude_mode, xsq=None):
    """One shard's gather-probed candidates over its own chunk tables
    (``ivf_gather_search_chunked``: its over-budget branch, the dense
    masked probed scan, is this shard's own host ``if``). → (candidates,
    whether this shard took the scan)."""
    if xsq is None:
        xsq = v_loc.float().square().sum(-1)
    dists, loc, scanned = ivf_gather_search_chunked(
        q.float(), v_loc, xsq, ids_loc, excl, centroids, cr_loc, cc_loc,
        cells_loc, k, nprobe=nprobe, budget=budget, n_valid=n_valid,
        exclude_mode=exclude_mode)
    loc = loc.long()
    rows = v_loc[loc.clamp_min(0).reshape(-1)].reshape(
        loc.shape + (v_loc.shape[1],))
    return _candidates(-dists, loc, shard * v_loc.shape[0], rows,
                       lab_loc), scanned


def sharded_retrieve_ivf_gather(mesh: Mesh, q, vectors, labels, ids,
                                exclude_ids, centroids, cells, chunk_rows,
                                cell_chunks, n_valid_shard: int, *, k: int,
                                nprobe: int, budget: int, metric: str = "L2",
                                exclude_mode: str = "batch", xsq=None
                                ) -> Tuple[ShardedRetrieval, bool]:
    """Gather-probed IVF over the sharded rows: each shard gathers only its
    probed cells' chunks (``chunk_rows [NC, w]`` local row ids,
    ``cell_chunks [nlist, MC]`` local chunk ids, ``n_valid_shard`` its
    valid rows), then the merge. The candidate set is the masked sharded
    IVF's: every local row of each query's probed cells. → (results,
    whether this rank's shard took its dense masked scan)."""
    if metric != "L2":
        raise ValueError("gather-probed IVF is an L2 path (IVF contract)")
    excl = _exclusion(mesh, exclude_ids, exclude_mode)  # before the branch
    cands, scanned = _gather_shard(
        q, vectors, labels, ids, excl, centroids, cells, chunk_rows,
        cell_chunks, int(n_valid_shard), mesh.coord(INDEX_AXIS), k=k,
        nprobe=nprobe, budget=budget, exclude_mode=exclude_mode, xsq=xsq)
    return _merge_shard_candidates(mesh, cands, k, metric), scanned


def plain_sharded_retrieve_ivf_gather(q, vectors, labels, ids, exclude_ids,
                                      centroids, cells, chunk_rows,
                                      cell_chunks, n_valid_shard, *,
                                      shards: int, k: int, nprobe: int,
                                      budget: int,
                                      exclude_mode: str = "batch"
                                      ) -> ShardedRetrieval:
    """``sharded_retrieve_ivf_gather`` in one process over the whole table
    and the stacked tables of ``build_sharded_chunk_tables``."""
    vb, lb, ib, cb, crb, ccb = _blocks(shards, vectors, labels, ids, cells)\
        + [chunk_rows.chunk(shards), cell_chunks.chunk(shards)]
    nv = [int(v) for v in n_valid_shard]
    return _plain_merge(shards, lambda i: _gather_shard(
        q, vb[i], lb[i], ib[i], exclude_ids, centroids, cb[i], crb[i],
        ccb[i], nv[i], i, k=k, nprobe=nprobe, budget=budget,
        exclude_mode=exclude_mode)[0], k, "L2")


def build_sharded_chunk_tables(cells: np.ndarray, n_valid: int, nlist: int,
                               num_shards: int
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, list]:
    """Per-shard chunk tables for ``sharded_retrieve_ivf_gather`` (the JAX
    package's numpy code; the same bytes). ``cells`` is the capacity-padded
    assignment; rows past ``n_valid`` are in no table. → chunk_rows
    ``[S * NC, w]`` (local row ids), cell_chunks ``[S * nlist, MC]`` (local
    chunk ids), n_valid_shard ``[S]``, and each shard's (cell_chunks,
    counts) for the budget."""
    cells = np.asarray(cells)
    s = int(num_shards)
    rps = cells.shape[0] // s
    # one chunk width from the mean local cell (pow2 in [8, 128])
    mean_cell = max(1.0, n_valid / max(1, s * nlist))
    w = 8
    while w * 2 <= min(128, mean_cell):
        w *= 2
    per = []
    for i in range(s):
        lo = i * rps
        vn = int(np.clip(n_valid - lo, 0, rps))
        per.append(build_chunk_table(cells[lo:lo + rps], vn, nlist,
                                     chunk=w))
    nc = max(cr.shape[0] for cr, _, _ in per)
    mc = max(cc.shape[1] for _, cc, _ in per)
    chunk_rows = np.full((s * nc, w), -1, np.int32)
    cell_chunks = np.full((s * nlist, mc), -1, np.int32)
    budget_stats = []
    for i, (cr, cc, cnt) in enumerate(per):
        chunk_rows[i * nc:i * nc + cr.shape[0]] = cr
        cc_pad = np.full((nlist, mc), -1, np.int32)
        cc_pad[:, :cc.shape[1]] = cc
        cell_chunks[i * nlist:(i + 1) * nlist] = cc_pad
        budget_stats.append((cc_pad, cnt))
    n_valid_shard = np.array(
        [int(np.clip(n_valid - i * rps, 0, rps)) for i in range(s)],
        np.int32)
    return chunk_rows, cell_chunks, n_valid_shard, budget_stats


def gather_budget(stats, nprobe: int) -> int:
    """One chunk budget for every shard: the largest of the shards'
    ``default_chunk_budget`` (every rank computes it from every shard's
    statistics, so all ranks agree)."""
    return max(default_chunk_budget(cc, cnt, nprobe) for cc, cnt in stats)


# SQ8's int8 scan on CUDA takes a shard's rows in multiples of 8
SQ8_SHARD_ROWS = 8


def shard_capacity(n: int, shards: int, rows_multiple: int = 1) -> int:
    """The capacity that ``n`` rows are padded to before they are split
    over ``shards`` row blocks: the least multiple of ``shards *
    rows_multiple`` that holds them. ``ShardedIndex`` takes JAX's multiple
    of the axis size (``rows_multiple`` 1); the pipeline, whose SQ8 shards
    scan with ``int8_scan``, ``SQ8_SHARD_ROWS``."""
    step = shards * rows_multiple
    return -(-n // step) * step


def pad_rows(x, cap: int, fill=0):
    """``x`` (a numpy array or a tensor) padded with ``fill`` rows to
    ``cap`` rows."""
    if x.shape[0] >= cap:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_full((cap - x.shape[0],)
                                        + tuple(x.shape[1:]), fill)])
    pad = [(0, cap - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=fill)


def move_index(index, device) -> None:
    """Every tensor of ``index`` (a ``FlatIndex`` or ``QuantizedIndex``) to
    ``device``, which becomes the index's."""
    device = torch.device(device)
    for name, val in list(vars(index).items()):
        if isinstance(val, torch.Tensor):
            setattr(index, name, val.to(device))
    index.device = device


class ShardedIndex:
    """A rank's block of a row-sharded index: the capacity padded to a
    multiple of the 'index' axis, each rank keeping its own rows (on the
    mesh's device); with IVF, the replicated coarse quantizer and the
    rank's chunk tables. ``build`` / ``build_ivf`` take a whole table (JAX
    ``ShardedIndex``); ``from_index`` takes the pipeline's index (JAX
    ``_place_index_on_mesh``): flat, IVF, or SQ8 plain or residual.

    ``retrieve`` is the index classes' (``FlatIndex.retrieve``): SQ8's
    sharded search; IVF's gather route on the predict paths (``serving``)
    where 2 b budget chunk < the rows of a shard, each rank deciding for
    its own batch slice; otherwise the flat search, which with IVF masks
    each query's unprobed cells at ``nprobe`` (on a mesh train and eval
    probe too, unlike the single-device dispatch). A block made by
    ``from_index`` counts its searches in that index."""

    def __init__(self, mesh: Mesh, dimension: int, metric: str = "L2"):
        self.mesh = mesh
        self.dimension = int(dimension)
        self.metric = metric.upper()
        self.n = 0
        self.vectors = self.labels = self.ids = self.row_valid = None
        self.norms_sq = None  # the rows' |x|^2 (None: from the rows)
        self.codes = self.scales = self.norm_sq = None  # SQ8
        self.centroids = self.cells = None
        self.nprobe = 32
        self.chunk_rows = self.cell_chunks = None
        self.n_valid_shard = 0
        self._budget_stats = None
        self._budgets: dict = {}  # nprobe -> the budget every shard shares
        self.host = None  # the index that counts the searches

    @property
    def num_shards(self) -> int:
        return self.mesh.index

    def _local(self, x) -> torch.Tensor:
        """This rank's row block of ``x`` (numpy or a tensor), copied onto
        the mesh's device."""
        return index_sharding(self.mesh, torch.as_tensor(x)).to(
            self.mesh.device, copy=True)

    def build(self, vectors: np.ndarray, labels, ids) -> None:
        """Every rank passes the whole table; each keeps its block."""
        vectors = np.asarray(vectors, np.float32)
        n, d = vectors.shape
        if d != self.dimension:
            raise ValueError(f"dim mismatch: {d} != {self.dimension}")
        if self.metric == "COSINE":
            vectors = vectors / np.maximum(
                np.linalg.norm(vectors, axis=-1, keepdims=True), 1e-12)
        cap = shard_capacity(n, self.num_shards)
        self.vectors = self._local(pad_rows(vectors, cap))
        self.labels = self._local(pad_rows(np.asarray(labels, np.float32),
                                           cap))
        self.ids = self._local(pad_rows(np.asarray(ids, np.int32), cap, -1))
        self.row_valid = self._local(np.arange(cap) < n)
        self.n = n

    @classmethod
    def from_index(cls, mesh: Mesh, index) -> "ShardedIndex":
        """This rank's block of ``index`` (the same rows on every rank):
        the capacity padded by ``shard_capacity`` to a multiple of
        ``SQ8_SHARD_ROWS`` x the 'index' axis (padding rows have id -1),
        the stored ``norms_sq`` as the scan's |x|^2, the IVF and
        residual-SQ8 centroids whole, IVF's chunk tables. ``index`` then
        moves to the host, where it serves saves and later adds, never a
        search. Its rows were normalized at add, and JAX's mesh search
        leaves a COSINE query as it is: COSINE searches as IP here."""
        metric = {"IVF": "L2", "COSINE": "IP"}.get(index.metric,
                                                   index.metric)
        self = cls(mesh, index.dimension, metric)
        cap = shard_capacity(index.ids.shape[0], mesh.index, SQ8_SHARD_ROWS)

        def block(t, fill=0):
            return self._local(pad_rows(t, cap, fill))

        quantized = isinstance(index, QuantizedIndex)
        if quantized:
            self.codes, self.scales, self.norm_sq = (
                block(index.codes), block(index.scales),
                block(index.norm_sq))
        else:
            self.vectors = block(index.vectors)
            self.norms_sq = block(index.norms_sq)
        self.labels, self.ids = block(index.labels), block(index.ids, -1)
        self.row_valid = self.ids >= 0
        self.n = index.ntotal
        self.host = index
        if index.centroids is not None and quantized:
            self.centroids = index.centroids.to(mesh.device, copy=True)
            self.cells = block(index.cells)
        elif index.centroids is not None:
            self.nprobe = index.nprobe
            self.build_ivf(index.centroids.cpu().numpy(),
                           index.cells[: index.n].cpu().numpy())
        move_index(index, "cpu")
        return self

    def build_ivf(self, centroids: np.ndarray, cells: np.ndarray) -> None:
        """The replicated quantizer and this rank's chunk tables over the
        capacity-padded cells (``cells`` covers the valid rows)."""
        if self.vectors is None:
            raise RuntimeError("build() before build_ivf()")
        cap = self.vectors.shape[0] * self.num_shards
        nlist = int(np.asarray(centroids).shape[0])
        cells_p = np.zeros((cap,), np.int32)
        cells_p[: self.n] = np.asarray(cells, np.int32)[: self.n]
        chunk_rows, cell_chunks, n_valid_shard, stats = (
            build_sharded_chunk_tables(cells_p, self.n, nlist,
                                       self.num_shards))
        self.centroids = torch.as_tensor(np.asarray(centroids, np.float32),
                                         device=self.mesh.device)
        self.cells = self._local(cells_p)
        self.chunk_rows = self._local(chunk_rows)
        self.cell_chunks = self._local(cell_chunks)
        self.n_valid_shard = int(n_valid_shard[self.mesh.coord(INDEX_AXIS)])
        self._budget_stats = stats
        self._budgets = {}

    def gather_budget(self, nprobe: int) -> int:
        if nprobe not in self._budgets:
            self._budgets[nprobe] = gather_budget(self._budget_stats, nprobe)
        return self._budgets[nprobe]

    def _count(self, gather: bool = False, fell_back: bool = False) -> None:
        if self.host is not None:
            count = (self.host.count_gather_search if gather
                     else self.host.count_search)
            count(fell_back)

    def retrieve(self, tpp, exclude_ids, *, k: int,
                 exclude_mode: str = "batch",
                 serving: bool = False) -> ShardedRetrieval:
        """``tpp [b, D]`` and ``exclude_ids [b]``, the rank's batch slice →
        its queries' (neighbors, labels, dists, indices), the same on every
        rank of its index group (class docstring)."""
        q = tpp
        if self.metric == "COSINE":
            q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        if self.codes is not None:
            ret = sharded_retrieve_sq8(
                self.mesh, q, self.codes, self.scales, self.norm_sq,
                self.labels, self.ids, exclude_ids, k=k, metric=self.metric,
                centroids=self.centroids, cells=self.cells,
                exclude_mode=exclude_mode)
            self._count()
            return ret
        if serving and self.chunk_rows is not None:
            nprobe = min(self.nprobe, self.centroids.shape[0])
            if (2 * q.shape[0] * self.gather_budget(nprobe)
                    * self.chunk_rows.shape[1] < self.vectors.shape[0]):
                return self.retrieve_gather(q, exclude_ids, k, nprobe,
                                            exclude_mode)
        ret = sharded_retrieve(
            self.mesh, q, self.vectors, self.labels, self.ids,
            self.row_valid, exclude_ids, k=k, metric=self.metric,
            centroids=self.centroids, cells=self.cells, nprobe=self.nprobe,
            exclude_mode=exclude_mode, xsq=self.norms_sq)
        self._count()
        return ret

    def retrieve_gather(self, q, exclude_ids, k: int, nprobe: int,
                        exclude_mode: str = "batch") -> ShardedRetrieval:
        """Gather-probed IVF retrieval: the masked sharded IVF's
        candidates, each shard touching only its probed cells' chunks."""
        if self.chunk_rows is None:
            raise RuntimeError("build_ivf() before retrieve_gather()")
        ret, scanned = sharded_retrieve_ivf_gather(
            self.mesh, q, self.vectors, self.labels, self.ids, exclude_ids,
            self.centroids, self.cells, self.chunk_rows, self.cell_chunks,
            self.n_valid_shard, k=k, nprobe=nprobe,
            budget=self.gather_budget(nprobe), metric=self.metric,
            exclude_mode=exclude_mode, xsq=self.norms_sq)
        self._count(gather=True, fell_back=scanned)
        return ret
