"""The comparison that decides ``correct``.

Serving, stage by stage, on a sample of the window's answers drawn from the
seed (the program's outputs are read only to judge them):

- ``embed_err``: the program's clip embedding against the reference's
  float32 one of the same WAV file, ``|e_p - e_r| / |e_r|``, the worst clip;
- ``search_gap``: the program's neighbors of its own embedding against the
  float64 truth over the same rows under the same self-exclusion: the
  largest gap, at any rank, between the float64 distances of the returned
  rows and the true k smallest, or between a returned distance and the
  float64 one of its row, as a share of the float32 rounding bound
  (``reference/search.py``); a wrong label or a missing neighbor reads inf;
- ``logit_err``: the program's logit against the reference's float64
  fusion model on the program's embedding and its neighbors' rows,
  ``|l_p - l_r| / max(|l_r|, median |l_r|)``, the worst clip;
  ``logit_rounding`` the program's summed logit error over the summed
  error of the same reference fusion model computed in the precision the
  configuration states (float32, or bfloat16 operands and results), on
  the same inputs: the program's error in units of its precision's own
  rounding, which takes out how sensitive a seed's weights make the logit.

A configuration's ``limits`` name the numbers it compares.

Training, over the first three steps: ``loss_gap`` (each step's loss,
relative), ``grad_gap`` (the first update's input per leaf, the clipped
gradient plus decay that Adam's first moment holds after one step) and
``change_gap`` (each leaf's change after three steps), both as the gap of
the leaf's norms over the larger of the reference's norm of that leaf and
of the median leaf, the worst leaf; leaves whose first reference gradient
is under a thousandth of the median leaf's move by round-off alone and are
left out of ``change_gap``.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Mapping

import torch

from reference import fusion as RF
from reference import search as RS


def judge_serving(tpp_p: torch.Tensor, got_rows: torch.Tensor,
                  got_d: torch.Tensor, got_labels: torch.Tensor,
                  logit_p: torch.Tensor, tpp_r: torch.Tensor,
                  rows: torch.Tensor, row_ids: torch.Tensor,
                  row_labels: torch.Tensor, exclude: torch.Tensor,
                  fus_w: Mapping[str, torch.Tensor], n_hidden: int,
                  fusion_kind: str = "exact") -> Dict[str, float]:
    """Arguments for S sampled answers: the program's embeddings ``[S, D]``,
    neighbor rows ``[S, k]`` (-1 where missing), distances and labels
    ``[S, k]``, logits ``[S]``; the reference's embeddings; the index rows,
    their ids and labels; each query's own id."""
    k = got_rows.shape[1]
    n = rows.shape[0]
    err = ((tpp_p.double() - tpp_r.double()).norm(dim=-1)
           / tpp_r.double().norm(dim=-1))
    mask = RS.mask_rows(row_ids, n, exclude, "self")
    d64, true_d, true_rows = RS.nearest(tpp_p, rows, mask, k)
    safe = got_rows.clamp_min(0).long()
    got64 = d64.gather(1, safe)
    tol = RS.f32_tolerance(tpp_p, rows, torch.cat([safe, true_rows], 1), n)
    gap = torch.maximum(
        (got64.sort(-1).values - true_d).abs().amax(-1),
        (got_d.double() - got64).abs().amax(-1)) / tol
    bad = ((got_rows < 0).any(-1)
           | (got_labels.double() != row_labels[safe].double()).any(-1)
           | ~torch.isfinite(got64).all(-1))
    gap = torch.where(bad, torch.full_like(gap, float("inf")), gap)
    w64 = {name: t.double() for name, t in fus_w.items()}
    logit_r = RF.forward(w64, rows[safe].double(), tpp_p.double(),
                         n_hidden=n_hidden)
    scale = torch.maximum(logit_r.abs(), logit_r.abs().median())
    lerr = (logit_p.double() - logit_r).abs() / scale
    w32 = {name: t.float() for name, t in fus_w.items()}
    logit_q = RF.forward(w32, rows[safe].float(), tpp_p.float(),
                         n_hidden=n_hidden, kind=fusion_kind).double()
    own = (logit_q - logit_r).abs().sum()
    rounding = (logit_p.double() - logit_r).abs().sum() / own
    return {"embed_err": float(err.max()), "search_gap": float(gap.max()),
            "logit_err": float(lerr.max()),
            "logit_rounding": float(rounding)}


def leaf_gap(prog: Mapping[str, torch.Tensor],
             ref: Mapping[str, torch.Tensor], keep=None) -> float:
    """The worst leaf's gap of norms, over the larger of the reference's
    norm of that leaf and of the median leaf."""
    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(ref[n].double().norm()) for n in names}
    pn = {n: float(prog[n].double().norm()) for n in names}
    med = statistics.median(rn.values())
    return max(abs(pn[n] - rn[n]) / max(rn[n], med) for n in names)


def moving_leaves(grads: Mapping[str, torch.Tensor]) -> List[str]:
    """Leaves whose gradient norm is at least a thousandth of the median
    leaf's."""
    norms = {n: float(g.double().norm()) for n, g in grads.items()}
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= 1e-3 * med]


def judge_train(losses_p: List[float], given1_p, change_p, losses_r,
                given1_r, change_r, grad1_r) -> Dict[str, float]:
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r))
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(given1_p, given1_r),
            "change_gap": leaf_gap(change_p, change_r,
                                   keep=set(moving_leaves(grad1_r)))}
