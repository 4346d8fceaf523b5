"""Hold a ``flat_topk`` result to exact arithmetic.

Used by ``chip_smoke.py`` and the tests to check the CUDA kernel
(``csrc/flat_topk.cu``) and its plain version; no serving path imports it.

The reference is the f64 evaluation of the same operands: q and x rounded
to bf16 (round to nearest even) with ``fast_scan``, ``|x|^2`` from the
stored rows. Products of bf16 or f32 values are exact in f64, and the f64
sums are 2^29 times more precise than the f32 ones they check, so the
reference is exact for this purpose.

The limit on each value is a rigorous first-order bound on the f32
rounding of the kernel's own summation order (``pair_scores``), computed
from that pair's partial sums. It is not the order-free worst case
``gamma_D * sum|terms|``, which at D = 5,376 exceeds the gap between
neighboring scores; a change to the kernel's summation order must change
``pair_scores`` with it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

U = 2.0 ** -24  # f32 unit roundoff
# csrc/flat_topk.cu: D streams in chunks of kDC = 32 columns; 8 loader
# threads per row each take one group of 4 columns of a chunk
_CHUNK, _LOADERS, _GROUP = 32, 8, 4
_ROW_BLOCK = 4096  # rows per f64 block of the all-rows evaluation


def _operand(t: torch.Tensor, fast_scan: bool) -> torch.Tensor:
    """An operand of the products, as the kernel takes it, in f64."""
    t = t.float()
    return (t.to(torch.bfloat16) if fast_scan else t).double()


def pair_scores(q: torch.Tensor, vectors: torch.Tensor, rows: torch.Tensor,
                *, metric: str = "L2", fast_scan: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact ``flat_topk`` values of the pairs (query ``b``, row
    ``rows[b, j]``) and a bound on the kernel's f32 error for each.
    ``q [B, D]``, ``rows [B, R]`` (all ``>= 0``) → ``(exact [B, R] f64,
    bound [B, R] f64)``.

    The kernel's order: ``q.x`` is one f32 FMA chain over the columns in
    order, one rounding per step, so its error is at most ``u * sum_d
    |P_d|`` over the exact partial sums ``P_d``. ``|x|^2``: each loader
    thread sums a group's 4 squares (4 rounded squares, 3 rounded adds: at
    most ``4u`` of the group's sum), adds it to its running sum (``u`` of
    each running sum ``C``), and a 3-level shuffle tree joins the 8 threads
    (``3u`` of the total ``S``): ``u (7 S + sum C)``. L2 then rounds
    ``2 q.x - |x|^2`` once, and the wrapper subtracts its f32 ``|q|^2``
    (whose error is taken as computed here, by the same expression) and
    rounds once more. The factor ``1 + 2 D u`` covers the second-order
    terms."""
    b, r = rows.shape
    d = q.shape[1]
    x = vectors[rows.reshape(-1).long()].reshape(b, r, d)
    qm, xm = _operand(q, fast_scan), _operand(x, fast_scan)
    partial = (qm[:, None, :] * xm).cumsum(-1)
    dot = partial[..., -1]
    dot_err = U * partial.abs().sum(-1)
    slack = 1.0 + 2.0 * d * U
    if metric != "L2":
        return dot, dot_err * slack
    sq = F.pad(x.double().square(), (0, (-d) % _CHUNK))
    groups = sq.reshape(b, r, -1, _LOADERS, _GROUP).sum(-1)  # [B,R,chunks,8]
    xsq = groups.sum((-1, -2))
    xsq_err = U * (7.0 * xsq + groups.cumsum(-2).sum((-1, -2)))
    score = 2.0 * dot - xsq
    qsq64 = q.double().square().sum(-1, keepdim=True)
    qsq32 = q.float().square().sum(-1, keepdim=True).double()
    exact = score - qsq64
    err = (2.0 * dot_err + xsq_err + U * score.abs()
           + (qsq32 - qsq64).abs() + U * exact.abs())
    return exact, err * slack


def _all_scores(q, vectors, metric, fast_scan):
    """Exact values of every (query, row) pair ``[B, N]`` f64, in blocks
    of rows."""
    qm = _operand(q, fast_scan)
    qsq = q.double().square().sum(-1, keepdim=True)
    out = []
    for s in range(0, vectors.shape[0], _ROW_BLOCK):
        x = vectors[s: s + _ROW_BLOCK]
        dot = qm @ _operand(x, fast_scan).t()
        if metric == "L2":
            dot = 2.0 * dot - x.double().square().sum(-1)[None, :] - qsq
        out.append(dot)
    return torch.cat(out, -1)


def check_topk(q: torch.Tensor, vectors: torch.Tensor, result, *,
               metric: str = "L2", fast_scan: bool = True,
               n_valid: Optional[int] = None,
               ids: Optional[torch.Tensor] = None,
               exclude_ids: Optional[torch.Tensor] = None) -> dict:
    """Hold one ``flat_topk`` result ``(vals [B, k], rows [B, k])`` to its
    contract on these inputs:

    * no returned row is at or past ``n_valid`` or has the query's
      excluded id, and no row comes twice; ``(-inf, -1)`` fills exactly
      the slots past the number of unmasked rows;
    * every value is within ``pair_scores``' bound of the exact value of
      its row, and the values do not increase;
    * no unmasked row left out scores, exactly, more than the last
      returned value plus its own bound (the set is a true top-k up to
      near-ties the f32 rounding may order either way).

    → dict(ok, problems, max_abs_err, max_bound, near_cut): the largest
    value error and bound over the returned rows, and how many rows left
    out score exactly above the last returned value."""
    vals, rows = result
    n = vectors.shape[0]
    b, k = rows.shape
    n_valid = n if n_valid is None else min(int(n_valid), n)
    mask = (torch.arange(n, device=q.device) >= n_valid)[None, :].expand(b, n)
    if ids is not None and exclude_ids is not None:
        mask = mask | (ids[None, :] == exclude_ids[:, None])
    problems = []
    ri = rows.long()
    found = ri >= 0
    safe = ri.clamp_min(0)
    if bool((found & mask.gather(1, safe)).any()):
        problems.append("a returned row is past n_valid or excluded")
    avail = (~mask).sum(-1).clamp(max=k)
    want_found = torch.arange(k, device=q.device)[None, :] < avail[:, None]
    if not torch.equal(found, want_found) or not torch.equal(
            found, torch.isfinite(vals)):
        problems.append("empty slots (-inf, -1) where rows were available")
    srt = ri.sort(-1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
        problems.append("a row is returned twice")
    exact, bound = pair_scores(q, vectors, safe, metric=metric,
                               fast_scan=fast_scan)
    zero = torch.zeros_like(exact)
    err = (vals.double() - exact).abs().where(found, zero)
    if bool((err > bound).any()):
        worst = int((err - bound).flatten().argmax())
        problems.append(f"a value is {float(err.flatten()[worst]):.3e} off "
                        f"its exact score, bound "
                        f"{float(bound.flatten()[worst]):.3e}")
    if bool((vals[:, 1:] > vals[:, :-1]).any()):
        problems.append("values increase along a row")
    cut = vals[:, -1].double()
    returned = torch.zeros((b, n + 1), dtype=torch.bool, device=q.device)
    returned.scatter_(1, torch.where(found, ri, n), True)  # empties → n
    scores = _all_scores(q, vectors, metric, fast_scan)
    above = ~mask & ~returned[:, :n] & (scores > cut[:, None])
    bi, mi = above.nonzero(as_tuple=True)
    if bi.numel():
        e_m, b_m = pair_scores(q[bi], vectors, mi[:, None], metric=metric,
                               fast_scan=fast_scan)
        if bool((e_m[:, 0] > cut[bi] + b_m[:, 0]).any()):
            problems.append("a row left out beats the last returned value "
                            "by more than its rounding bound")
    empty = err.numel() == 0
    return dict(ok=not problems, problems=problems,
                max_abs_err=0.0 if empty else float(err.max()),
                max_bound=0.0 if empty else float(
                    bound.where(found, zero).max()),
                near_cut=int(bi.numel()))


def compare_topk(q: torch.Tensor, vectors: torch.Tensor, a, b, *,
                 metric: str = "L2", fast_scan: bool = True) -> dict:
    """Two ``flat_topk`` results ``a = (vals, rows)`` and ``b`` for the same
    inputs (a kernel and its plain version). Where they hold the same row,
    the values may differ by twice its ``pair_scores`` bound; where their
    rows differ, the two rows' exact scores must lie within the sum of
    their bounds, a near-tie that f32 rounding may order either way; an
    empty slot must face an empty slot. → dict(ok, rows_differ,
    max_abs_err, max_gap): the largest value difference on a shared row,
    and the largest exact gap between rows that trade places."""
    (av, ai), (bv, bi) = a, b
    diff = ai != bi
    both = (ai >= 0) & (bi >= 0)
    ea, ba = pair_scores(q, vectors, ai.long().clamp_min(0), metric=metric,
                         fast_scan=fast_scan)
    zero = torch.zeros_like(ea)
    vdiff = (av.double() - bv.double()).abs().where(~diff & both, zero)
    ok = not bool((diff & ~both).any()) and bool((vdiff <= 2.0 * ba).all())
    gap = zero
    if bool((diff & both).any()):
        eb, bb = pair_scores(q, vectors, bi.long().clamp_min(0),
                             metric=metric, fast_scan=fast_scan)
        gap = (ea - eb).abs().where(diff & both, zero)
        ok = ok and bool((gap <= ba + bb).all())
    return dict(ok=ok, rows_differ=int(diff.any(-1).sum()),
                max_abs_err=float(vdiff.max()) if vdiff.numel() else 0.0,
                max_gap=float(gap.max()) if gap.numel() else 0.0)
