"""Gather-probed IVF search: retrieval that touches only the probed cells.

Counterpart: ``radad_tpu/index/ivf_gather.py`` (``build_cell_table``,
``build_chunk_table``, ``default_chunk_budget``, ``ivf_gather_search``,
``ivf_gather_search_chunked``). The masked IVF route
(``flat._search_device`` with ``metric="IVF"``) scores every row and masks
the unprobed ones, so a batch reads the whole table whatever nprobe is;
this route gathers the probed cells' rows and scores only those. It is the
serving route of a large IVF index, where a predict call with B <= 8 must
not sweep N rows.

The three table builders are host numpy, copied from the JAX package (the
port imports nothing of it), so both packages build the same bytes:

* the span table: ``[nlist, span]`` row ids, -1 padded, span the 99.9th
  percentile cell size (rounded up to 8); the cell tails past span go to
  an overflow list that every query scans;
* the chunk table: each cell packed into fixed ``chunk``-row chunks (only
  a cell's last chunk carries padding), ``[n_chunks, chunk]`` row ids and
  ``[nlist, max_chunks]`` chunk ids a cell;
* the chunk budget: nprobe times the count-weighted mean chunks of a cell
  times 1.5, the chunks a chunked search gathers a query.

The searches run on tensors of any device:

* the coarse probe is f32 with TF32 off (JAX's HIGHEST), selected with
  ``top_k_stable`` so near-tied centroids resolve to the lower index, as
  ``lax.top_k`` does (``flat.probe_cells``);
* ``lax.map`` over queries becomes a batched row gather (``index_select``)
  and ``bmm`` a block of queries, each block's gathered f32 rows under
  ``GATHER_BLOCK_BYTES`` (JAX maps one query at a time to bound live memory
  to one query's candidates: ~0.4 GB at 1M rows, D = 5,376); a query whose
  candidates alone exceed it (its probed cells hold most of a 1M-row
  index: 28 GB) is scored in blocks of candidates, where JAX's one
  ``[C, D]`` take would not fit the device;
* the chunked search's ``lax.cond(overflowed, scan, gather)`` is a host
  ``if`` on one bool: when any query's probed cells hold more chunks than
  the budget, the whole batch takes the dense masked probed scan (a
  storage-dtype GEMM, then an exact f32 rescore of the top max(4k, 32)),
  and the search says so (``FlatIndex.ivf_gather_fallbacks`` counts it).

No Pallas kernel runs on this route in JAX (an XLA take, a HIGHEST dot and
``top_k``), and no CUDA kernel of the port runs here: the product is a
plain ``bmm`` and the gathers are ``index_select``.

Candidate sets: the span search scans the first span rows of every probed
cell plus the overflow of every cell, a superset of the masked route's;
the chunked search scans exactly every row of every probed cell, the
masked route's set. Scores are f32 against the stored exact row norms on
every route, so the results agree up to scores tied within f32 rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from radad_tpu_torch.index.flat import (bf16_mm_f32, fold_exclusion,
                                        probe_cells, probe_mask)
from radad_tpu_torch.ops.topk import NEG_INF, top_k_stable

# the gathered f32 candidate rows of one block of queries stay below this
GATHER_BLOCK_BYTES = 1 << 30


def _round8(n: int) -> int:
    return max(8, ((n + 7) // 8) * 8)


def build_cell_table(cells: np.ndarray, n_valid: int, nlist: int,
                     span_cap: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense inverted-list table from a per-row cell assignment.

    → (table [nlist, span] int32 row ids, -1 padded;
       counts [nlist] int32 true cell sizes;
       overflow [V] int32 row ids of cell tails past ``span``, -1 padded).

    ``span`` defaults to the 99.9th-percentile cell size (rounded up to a
    multiple of 8), so the overflow holds ~0.1 % of the rows; ``span_cap``
    overrides it."""
    cells = np.asarray(cells)[:n_valid].astype(np.int64)
    counts = np.bincount(cells, minlength=nlist).astype(np.int32)
    nonzero = counts[counts > 0]
    if span_cap is not None:
        span = int(span_cap)
    elif nonzero.size:
        span = int(np.quantile(nonzero, 0.999))
    else:
        span = 1
    if nonzero.size:
        span = min(span, int(nonzero.max()))
    span = _round8(span)
    order = np.argsort(cells, kind="stable").astype(np.int32)
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    table = np.full((nlist, span), -1, np.int32)
    overflow_parts = []
    for c in np.nonzero(counts)[0]:
        rows = order[starts[c]:starts[c + 1]]
        m = min(len(rows), span)
        table[c, :m] = rows[:m]
        if len(rows) > span:
            overflow_parts.append(rows[span:])
    if overflow_parts:
        ovf = np.concatenate(overflow_parts)
        ovf = np.pad(ovf, (0, _round8(len(ovf)) - len(ovf)),
                     constant_values=-1)
    else:
        ovf = np.full((8,), -1, np.int32)
    return table, counts, ovf.astype(np.int32)


def build_chunk_table(cells: np.ndarray, n_valid: int, nlist: int,
                      chunk: int = 128
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chunked inverted lists: each cell packed into fixed ``chunk``-row
    chunks.

    → (chunk_rows [n_chunks, chunk] int32 row ids, -1 padded (only each
       cell's last chunk carries padding);
       cell_chunks [nlist, max_chunks] int32 chunk ids, -1 padded;
       counts [nlist] int32 true cell sizes)."""
    cells = np.asarray(cells)[:n_valid].astype(np.int64)
    counts = np.bincount(cells, minlength=nlist).astype(np.int32)
    order = np.argsort(cells, kind="stable").astype(np.int32)
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    nchunks_per = (counts.astype(np.int64) + chunk - 1) // chunk
    total = max(1, int(nchunks_per.sum()))
    maxc = max(1, int(nchunks_per.max()) if nlist else 1)
    chunk_rows = np.full((total, chunk), -1, np.int32)
    cell_chunks = np.full((nlist, maxc), -1, np.int32)
    nxt = 0
    for c in np.nonzero(counts)[0]:
        rows = order[starts[c]:starts[c + 1]]
        for j in range(int(nchunks_per[c])):
            seg = rows[j * chunk:(j + 1) * chunk]
            chunk_rows[nxt, :len(seg)] = seg
            cell_chunks[c, j] = nxt
            nxt += 1
    return chunk_rows, cell_chunks, counts


def default_chunk_budget(cell_chunks: np.ndarray, counts: np.ndarray,
                         nprobe: int, slack: float = 1.5) -> int:
    """Chunks a chunked search gathers a query: ``nprobe`` times the
    count-weighted mean chunks of a cell (the chunks of the cell holding a
    random row: queries probe where the data is) times ``slack``, at least
    max(nprobe, 8) and at most every chunk. A batch whose probed cells
    exceed it takes the dense masked scan: a latency knob, not a recall
    knob."""
    ncc = (np.asarray(cell_chunks) >= 0).sum(1).astype(np.float64)
    w = np.asarray(counts, np.float64)
    tot = int(ncc.sum())
    if w.sum() <= 0 or tot == 0:
        return max(8, int(nprobe))
    wmean = float((w * ncc).sum() / w.sum())
    b = int(np.ceil(nprobe * wmean * slack))
    return int(min(max(b, nprobe, 8), tot))


# ----------------------------------------------------------------------
def _score_gathered(q, qsq, cand, vectors, xsq, ids, exclude_ids, kk):
    """Top-``kk`` of each query over its candidate rows ``cand [B, C]``
    (-1: none) by the L2 score -(|q|^2 - 2 q.x + |x|^2), the q.x an f32
    ``bmm`` of the gathered rows. The gathered f32 rows of a step stay
    under ``GATHER_BLOCK_BYTES``: blocks of queries, and blocks of one
    query's candidates where those alone exceed it (a query whose probed
    cells hold most of the index). Rows that are none or excluded score
    -inf. → (scores [B, kk], rows [B, kk])."""
    b, c = cand.shape
    d = vectors.shape[1]
    cols = max(1, min(c, GATHER_BLOCK_BYTES // (d * 4)))
    step = max(1, GATHER_BLOCK_BYTES // (cols * d * 4))
    tops, rows = [], []
    for lo in range(0, b, step):
        ci = cand[lo:lo + step]
        safe = ci.clamp_min(0).long()
        qb = q[lo:lo + step, :, None]
        qx = torch.cat([torch.bmm(
            vectors.index_select(0, part.reshape(-1)).float().reshape(
                part.shape + (d,)), qb)[..., 0]
            for part in safe.split(cols, 1)], 1)  # [b, C]
        scores = -(qsq[lo:lo + step, None] - 2.0 * qx + xsq[safe])
        bad = (ci < 0) | (ids[safe] == exclude_ids[lo:lo + step, None])
        top, pos = top_k_stable(scores.masked_fill(bad, NEG_INF), kk)
        tops.append(top)
        rows.append(ci.gather(1, pos))
    return torch.cat(tops), torch.cat(rows)


def _finish(top, idx, k):
    """Scores ``[B, kk]`` → (squared distances [B, k], rows [B, k] int32),
    padded to k; a slot with no finite score is (+inf, -1)."""
    kk = top.shape[1]
    if kk < k:
        top = torch.nn.functional.pad(top, (0, k - kk), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    valid = torch.isfinite(top)
    dists = torch.where(valid, -top, torch.full_like(top, float("inf")))
    return dists, torch.where(valid, idx, torch.full_like(idx, -1)).to(
        torch.int32)


def ivf_gather_search(q, vectors, xsq, ids, exclude_ids, centroids, table,
                      overflow, k, *, nprobe, exclude_mode="batch"):
    """Probed-cell gather search over the span table (L2).

    → (dists [B, k] f32 squared L2, idx [B, k] int32); invalid slots are
    (+inf, -1), as ``flat._search_device``. ``exclude_mode`` as there:
    "batch" rewrites every excluded row's id to the -3 sentinel (the
    exclusion list's length is independent of B, so a chunked caller can
    pass one call-level union), "self" masks each query's own id."""
    b = q.shape[0]
    nlist, span = table.shape
    nprobe_eff = min(int(nprobe), nlist)
    ids, exclude_ids = fold_exclusion(ids, exclude_ids, b, exclude_mode)
    probe = probe_cells(q, centroids, nprobe_eff)  # [B, nprobe]
    cand = torch.cat([table[probe].reshape(b, nprobe_eff * span),
                      overflow[None, :].expand(b, -1)], 1)  # [B, C]
    qsq = q.square().sum(-1)
    # the static candidate count can undercut k on tiny tables
    top, idx = _score_gathered(q, qsq, cand, vectors, xsq, ids, exclude_ids,
                               min(k, cand.shape[1]))
    return _finish(top, idx, k)


def ivf_gather_search_chunked(q, vectors, xsq, ids, exclude_ids, centroids,
                              chunk_rows, cell_chunks, cells, k, *, nprobe,
                              budget, n_valid, exclude_mode="batch"):
    """Chunk-compacted probed gather search (L2).

    → (dists [B, k], idx [B, k] int32, fell_back). Each query's probed
    cells' chunk ids are compacted, valid first in probe-rank order, to
    ``budget`` chunks, whose rows are gathered and scored. When any query's
    probed cells hold more than ``budget`` chunks the whole batch takes the
    dense masked probed scan instead (``fell_back`` True): the candidate
    set is every row of every probed cell either way."""
    b = q.shape[0]
    nlist, maxc = cell_chunks.shape
    csz = chunk_rows.shape[1]
    nprobe_eff = min(int(nprobe), nlist)
    pslots = nprobe_eff * maxc
    budget_eff = min(int(budget), pslots)
    ids, exclude_ids = fold_exclusion(ids, exclude_ids, b, exclude_mode)
    probe = probe_cells(q, centroids, nprobe_eff)
    cand_ch = cell_chunks[probe].reshape(b, pslots)  # probe-rank-major
    ch_valid = cand_ch >= 0
    pos = torch.arange(pslots, device=q.device)[None, :]
    key = torch.where(ch_valid, pos, pos + pslots)
    order = torch.argsort(key, dim=1, stable=True)[:, :budget_eff]
    sel = cand_ch.gather(1, order)  # [B, budget]
    qsq = q.square().sum(-1)
    overflowed = bool((ch_valid.sum(1) > budget_eff).any())
    cap = vectors.shape[0]
    kk = min(k, budget_eff * csz, cap)
    if overflowed:
        top, idx = _masked_probed_scan(q, qsq, vectors, xsq, ids,
                                       exclude_ids, probe, cells, nlist,
                                       n_valid, k, kk)
    else:
        rows = chunk_rows[sel.clamp_min(0).long()]  # [B, budget, chunk]
        rows = torch.where(sel[..., None] >= 0, rows,
                           torch.full_like(rows, -1))
        top, idx = _score_gathered(q, qsq, rows.reshape(b, budget_eff * csz),
                                   vectors, xsq, ids, exclude_ids, kk)
    dists, idx = _finish(top, idx, k)
    return dists, idx, overflowed


def _masked_probed_scan(q, qsq, vectors, xsq, ids, exclude_ids, probe, cells,
                        nlist, n_valid, k, kk):
    """The chunked search's over-budget branch: a storage-dtype GEMM over
    every row (f32 with TF32 off, or bf16 with an f32 accumulator), rows
    outside the probed cells, past ``n_valid`` or excluded masked, then an
    exact f32 rescore of the top max(4k, 32). → (scores [B, kk], rows)."""
    cap = vectors.shape[0]
    row_ids = torch.arange(cap, device=q.device)
    mask = (~probe_mask(probe, cells, nlist) | (row_ids >= n_valid)[None, :]
            | (ids[None, :] == exclude_ids[:, None]))
    if vectors.dtype == torch.bfloat16:
        qx = bf16_mm_f32(q.to(torch.bfloat16), vectors)
    else:
        qx = q @ vectors.t()
    scores = -(qsq[:, None] - 2.0 * qx + xsq[None, :])
    cs, ci = top_k_stable(scores.masked_fill(mask, NEG_INF),
                          min(max(4 * k, 32), cap))
    vs = vectors.index_select(0, ci.reshape(-1)).float().reshape(
        ci.shape + (vectors.shape[1],))
    qx2 = torch.bmm(vs, q[:, :, None])[..., 0]
    s2 = -(qsq[:, None] - 2.0 * qx2 + xsq[ci])
    top, p = top_k_stable(s2.masked_fill(~torch.isfinite(cs), NEG_INF), kk)
    return top, ci.gather(1, p)


def retrieve_on_device_ivf_gather_chunked(
        tpp, vectors, xsq, labels, ids, exclude_ids, centroids, chunk_rows,
        cell_chunks, cells, *, k, nprobe, budget, n_valid,
        exclude_mode="batch"):
    """``ivf_gather_search_chunked`` + the neighbor rows and labels, with
    ``flat.retrieve_on_device``'s output contract (missing neighbors are
    zero vectors with label 0, distance +inf and index -1). → (neighbors,
    nlabels, dists, idx, fell_back)."""
    dists, idx, fell_back = ivf_gather_search_chunked(
        tpp, vectors, xsq, ids, exclude_ids, centroids, chunk_rows,
        cell_chunks, cells, k, nprobe=nprobe, budget=budget,
        n_valid=n_valid, exclude_mode=exclude_mode)
    return _gathered_to_neighbors(vectors, labels, dists, idx) + (fell_back,)


def _gathered_to_neighbors(vectors, labels, dists, idx):
    """Neighbor rows and labels of ``idx`` by ``index_select`` (JAX's XLA
    take on this route, not the ``gather_rows`` kernel). → (neighbors
    [B, k, D] f32, labels [B, k], dists, idx)."""
    safe = idx.clamp_min(0).long()
    neighbors = vectors.index_select(0, safe.reshape(-1)).float().reshape(
        idx.shape + (vectors.shape[-1],))
    ok = idx >= 0
    neighbors = torch.where(ok[..., None], neighbors,
                            torch.zeros_like(neighbors))
    nlabels = torch.where(ok, labels[safe], torch.zeros_like(dists))
    return neighbors, nlabels, dists, idx
