"""Exact nearest neighbors under L2, and the rounding that a float32
search may carry.

``nearest`` is the truth: squared distances in float64 from each query to
every row, rows a query may not return masked, the k smallest (the lower
row first among equal values). ``f32_tolerance`` bounds, per query, how
far the float64 distances of the neighbors a float32 search returns may
lie from the true k smallest without the search being wrong: it ranks by
``|q|^2 - 2 q.x + |x|^2`` in float32, so two rows trade places only within
the rounding of those sums, ``2^-21 (|q|^2 + max |x|^2)`` for the three
terms and, for q.x and |x|^2, ``sqrt(D) 2^-24 (|x|^2 + 2 sum |q_d x_d|)``
(Higham and Mary's probabilistic bound) for each of the two rows.
"""

from __future__ import annotations

import torch

from reference import precision as P


def mask_rows(ids: torch.Tensor, n_valid: int, exclude: torch.Tensor,
              mode: str) -> torch.Tensor:
    """``[B, N]`` True where a query may not return a row: rows past
    ``n_valid``; "self": the row whose id is the query's own; "batch": any
    row whose id is one of the batch's."""
    n = ids.shape[0]
    invalid = torch.arange(n, device=ids.device) >= n_valid
    if mode == "self":
        return invalid[None, :] | (ids[None, :] == exclude[:, None])
    hit = invalid | torch.isin(ids, exclude)
    return hit[None, :].expand(exclude.shape[0], -1)


def distances(q: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
              block: int = 4096) -> torch.Tensor:
    """float64 squared distances ``[B, N]``, +inf where masked."""
    q64 = q.double()
    qsq = q64.square().sum(-1, keepdim=True)
    out = []
    for lo in range(0, rows.shape[0], block):
        x = rows[lo:lo + block].double()
        out.append(qsq - 2.0 * q64 @ x.t() + x.square().sum(-1)[None, :])
    return torch.cat(out, 1).masked_fill(mask, float("inf"))


def topk_smallest(d: torch.Tensor, k: int):
    """(values, row indices) of the k smallest per row, the lower index
    first among equal values."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[:, :k], idx[:, :k]


def nearest(q, rows, mask, k):
    """(float64 distances [B, N], true k smallest [B, k], their rows)."""
    d = distances(q, rows, mask)
    vals, idx = topk_smallest(d, k)
    return d, vals, idx


def f32_tolerance(q: torch.Tensor, rows: torch.Tensor,
                  picked: torch.Tensor, n_valid: int) -> torch.Tensor:
    """``[B]`` float64: the rounding bound above, over the rows ``picked
    [B, r]`` (the returned and the true neighbors)."""
    q64 = q.double()
    x = rows[picked.clamp_min(0).long()].double()  # [B, r, D]
    terms = x.square().sum(-1) + 2.0 * (x.abs() * q64.abs()[:, None]).sum(-1)
    dots = q.shape[-1] ** 0.5 * 2.0 ** -24 * terms.amax(-1)
    xmax = rows[:n_valid].double().square().sum(-1).max()
    return 2.0 ** -21 * (q64.square().sum(-1) + xmax) + 2.0 * dots


def scan(q: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, k: int,
         kind: str, block: int = 4096):
    """A float32 full scan whose products round as ``kind``: the search of
    the reference put in the program's place. → (float32 distances [B, k],
    rows [B, k])."""
    qf = q.float()
    qsq = qf.square().sum(-1, keepdim=True)
    parts = []
    for lo in range(0, rows.shape[0], block):
        x = rows[lo:lo + block].float()
        parts.append(qsq - 2.0 * P.matmul(qf, x.t(), kind)
                     + x.square().sum(-1)[None, :])
    d = torch.cat(parts, 1).masked_fill(mask, float("inf"))
    return topk_smallest(d, k)
