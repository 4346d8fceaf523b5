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
``pair_scores`` with it. Two orders, named by ``order``:

* ``"chain"`` (``CHAIN``): the f32 body (``fast_scan=False`` on CUDA), one
  FMA chain over D a pair;
* ``"mma"`` (``MMA``): the bf16 body (``fast_scan=True`` on CUDA), tensor-
  core blocks of 16 products added into an f32 chain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

U = 2.0 ** -24  # f32 unit roundoff
CHAIN, MMA = "chain", "mma"
# csrc/flat_topk.cu, f32 body: D streams in chunks of kDC = 32 columns; 8
# loader threads per row each take one group of 4 columns of a chunk
_CHUNK, _LOADERS, _GROUP = 32, 8, 4
# bf16 body: k16 products, 64-column ring stages (kMC); the 4 lanes of a
# row's A fragment
_K, _STAGE, _LANES = 16, 64, 4
# One k16 block sum with a zero accumulator, |error| <= C_MMA u sum|p|.
# Model (Fasi, Higham, Mikaitis, Pranesh, "Numerical behavior of NVIDIA
# tensor cores", PeerJ CS 2021): products exact; the addends of a pass
# aligned to the largest and truncated to 24 bits (< 1 ulp of the largest
# each, <= 2u sum|p|); the normalized result truncated (<= 2u sum|p|). The
# 16 products may take one pass (16 addends + 1: 34 u) or two k8 passes,
# the second with the first's result as an addend ((8 + 1) + (9 + 1): 40 u).
C_MMA = 40.0
_ROW_BLOCK = 4096  # rows per f64 block of the all-rows evaluation



def _operand(t: torch.Tensor, fast_scan: bool) -> torch.Tensor:
    """An operand of the products, as the kernel takes it, in f64."""
    t = t.float()
    return (t.to(torch.bfloat16) if fast_scan else t).double()


def _dot_bound(prod: torch.Tensor, order: str):
    """``q.x`` from its exact products ``prod [..., D]`` (f64), and a bound
    on the f32 error of its sum in ``order``."""
    if order == CHAIN:  # one rounding a step, over the exact partial sums
        partial = prod.cumsum(-1)
        return partial[..., -1], U * partial.abs().sum(-1)
    if order != MMA:
        raise ValueError(f"unknown summation order {order!r}")
    # k16 block sums (C_MMA u sum|p| each), then one rounding a block
    blocks = F.pad(prod, (0, (-prod.shape[-1]) % _K)).unflatten(-1, (-1, _K))
    partial = blocks.sum(-1).cumsum(-1)
    return partial[..., -1], U * (partial.abs().sum(-1)
                                  + C_MMA * prod.abs().sum(-1))


def _xsq_bound(x: torch.Tensor, order: str):
    """``|x|^2`` of the stored rows ``x [..., D]`` (exact, f64) and a bound
    on the f32 error of its sum in ``order``."""
    sq = x.double().square()
    if order == CHAIN:
        sq = F.pad(sq, (0, (-sq.shape[-1]) % _CHUNK))
        groups = sq.unflatten(-1, (-1, _LOADERS, _GROUP)).sum(-1)
        xsq = groups.sum((-1, -2))
        return xsq, U * (7.0 * xsq + groups.cumsum(-2).sum((-1, -2)))
    sq = F.pad(sq, (0, (-sq.shape[-1]) % _STAGE))
    # column 16k + 8h + 2t + e of each stage goes to lane t, which chains
    # its 16 columns of a stage in (k, h, e) order from 0, one rounding a
    # step, then adds the stage's sum to its running sum
    lanes = sq.unflatten(-1, (-1, _STAGE // _K, 2, _LANES, 2)).movedim(-2, -5)
    part = lanes.flatten(-3).cumsum(-1)  # [..., lane, stage, 16]
    run = part[..., -1].cumsum(-1)       # [..., lane, stage]
    xsq = run[..., -1].sum(-1)
    return xsq, U * (part.sum((-1, -2, -3)) + run.sum((-1, -2)) + 2.0 * xsq)


def pair_scores(q: torch.Tensor, vectors: torch.Tensor, rows: torch.Tensor,
                *, metric: str = "L2", fast_scan: bool = True,
                order: str = CHAIN) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact ``flat_topk`` values of the pairs (query ``b``, row
    ``rows[b, j]``) and a bound on the kernel's f32 error for each, for its
    summation ``order``. ``q [B, D]``, ``rows [B, R]`` (all ``>= 0``) →
    ``(exact [B, R] f64, bound [B, R] f64)``.

    ``"chain"``: ``q.x`` is one f32 FMA chain over the columns in order,
    one rounding per step, so its error is at most ``u * sum_d |P_d|`` over
    the exact partial sums ``P_d``. ``|x|^2``: each loader thread sums a
    group's 4 squares (4 rounded squares, 3 rounded adds: at most ``4u`` of
    the group's sum), adds it to its running sum (``u`` of each running sum
    ``C``), and a 3-level shuffle tree joins the 8 threads (``3u`` of the
    total ``S``): ``u (7 S + sum C)``.

    ``"mma"``: ``q.x`` is a chain of k16 tensor-core block sums, each issued
    with a zero accumulator (at most ``C_MMA u sum|p|`` of its 16 exact
    products, see ``C_MMA``) and added with one rounding to the running f32
    sum (``u`` of each exact partial sum over blocks ``S_j``): ``u (sum_j
    |S_j| + C_MMA sum_d |p_d|)``. ``|x|^2``: lane ``t`` of a row's 4
    fragment lanes takes columns ``2t, 2t+1, 8+2t, 9+2t`` of each k16
    block; over each 64-column stage it runs an fmaf chain of its 16 squares
    from 0 (``u`` of each partial ``c``), adds that to its running sum
    (``u`` of each running sum ``C``), and a 2-level shuffle tree joins the
    lanes (at most ``2u S``): ``u (sum c + sum C + 2 S)``.

    In both, L2 then rounds ``2 q.x - |x|^2`` once, and the wrapper
    subtracts its f32 ``|q|^2`` (whose error is taken as computed here, by
    the same expression) and rounds once more. The factor ``1 + 2 D u``
    covers the second-order terms."""
    b, r = rows.shape
    d = q.shape[1]
    x = vectors[rows.reshape(-1).long()].reshape(b, r, d)
    qm, xm = _operand(q, fast_scan), _operand(x, fast_scan)
    dot, dot_err = _dot_bound(qm[:, None, :] * xm, order)
    slack = 1.0 + 2.0 * d * U
    if metric != "L2":
        return dot, dot_err * slack
    xsq, xsq_err = _xsq_bound(x, order)
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
               exclude_ids: Optional[torch.Tensor] = None,
               order: str = CHAIN) -> dict:
    """Hold one ``flat_topk`` result ``(vals [B, k], rows [B, k])`` to its
    contract on these inputs:

    * no returned row is at or past ``n_valid`` or has the query's
      excluded id, and no row comes twice; ``(-inf, -1)`` fills exactly
      the slots past the number of unmasked rows;
    * every value is within ``pair_scores``' bound (for the summation
      ``order``) of the exact value of its row, and the values do not
      increase;
    * no unmasked row left out scores, exactly, more than the last
      returned value plus its own bound (the set is a true top-k up to
      near-ties the f32 rounding may order either way).

    → dict(ok, problems, max_abs_err, max_bound, max_ratio, near_cut): the
    largest value error, bound and error / bound over the returned rows,
    and how many rows left out score exactly above the last returned
    value."""
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
                               fast_scan=fast_scan, order=order)
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
                               fast_scan=fast_scan, order=order)
        if bool((e_m[:, 0] > cut[bi] + b_m[:, 0]).any()):
            problems.append("a row left out beats the last returned value "
                            "by more than its rounding bound")
    empty = err.numel() == 0
    return dict(ok=not problems, problems=problems,
                max_abs_err=0.0 if empty else float(err.max()),
                max_bound=0.0 if empty else float(
                    bound.where(found, zero).max()),
                max_ratio=0.0 if empty else float(
                    (err / bound.clamp_min(1e-300)).where(found, zero).max()),
                near_cut=int(bi.numel()))


def compare_topk(q: torch.Tensor, vectors: torch.Tensor, a, b, *,
                 metric: str = "L2", fast_scan: bool = True,
                 order: str = CHAIN) -> dict:
    """Two ``flat_topk`` results ``a = (vals, rows)`` and ``b`` for the same
    inputs (a kernel and its plain version). Where they hold the same row,
    the values may differ by twice its ``pair_scores`` bound (for the
    summation ``order`` of ``a``; ``b``'s plain version is taken to round
    no worse); where their
    rows differ, the two rows' exact scores must lie within the sum of
    their bounds, a near-tie that f32 rounding may order either way; an
    empty slot must face an empty slot. → dict(ok, rows_differ,
    max_abs_err, max_gap): the largest value difference on a shared row,
    and the largest exact gap between rows that trade places."""
    (av, ai), (bv, bi) = a, b
    diff = ai != bi
    both = (ai >= 0) & (bi >= 0)
    ea, ba = pair_scores(q, vectors, ai.long().clamp_min(0), metric=metric,
                         fast_scan=fast_scan, order=order)
    zero = torch.zeros_like(ea)
    vdiff = (av.double() - bv.double()).abs().where(~diff & both, zero)
    ok = not bool((diff & ~both).any()) and bool((vdiff <= 2.0 * ba).all())
    gap = zero
    if bool((diff & both).any()):
        eb, bb = pair_scores(q, vectors, bi.long().clamp_min(0),
                             metric=metric, fast_scan=fast_scan, order=order)
        gap = (ea - eb).abs().where(diff & both, zero)
        ok = ok and bool((gap <= ba + bb).all())
    return dict(ok=ok, rows_differ=int(diff.any(-1).sum()),
                max_abs_err=float(vdiff.max()) if vdiff.numel() else 0.0,
                max_gap=float(gap.max()) if gap.numel() else 0.0)
