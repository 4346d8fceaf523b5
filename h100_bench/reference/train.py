"""The first steps of training, followed by the plain reference.

Each step: the batch's rows are the queries; the k nearest rows by L2
(float64, or a float32 scan rounded as ``kind``) among those whose id is
not one of the batch's are the neighbors (``swaps``: the queries whose
k-th and (k+1)-th neighbors are tied within float32's rounding, see
``tied``, take the (k+1)-th in place of the k-th, as a float32 search may); the fusion model's training
forward (dropout masks drawn from a generator seeded as the program seeds
its own); the weighted BCE over the valid rows; the gradients; the
optimizer step (``reference/fusion.py``).

``fault`` plants a fault of a training step, for the controls: "unchanged"
(the step leaves the parameters and the optimizer's state as they were),
"half_batch" (the second half of the batch left out, the mean taken over
the rest) or "altered" (one row's logit moved by 1 where it is produced).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from reference import fusion as RF
from reference import search as RS


def tied(rows: torch.Tensor, ids: torch.Tensor,
         batches: List[torch.Tensor], k: int) -> List[tuple]:
    """(step, query) of every query whose k-th and (k+1)-th nearest rows
    lie within the float32 rounding bound of each other: a float32 search
    may return either. Depends on the rows alone."""
    out = []
    n = rows.shape[0]
    for step, b in enumerate(batches):
        q = rows[b]
        mask = RS.mask_rows(ids, n, ids[b], "batch")
        _, vals, idx = RS.nearest(q, rows, mask, k + 1)
        tol = RS.f32_tolerance(q, rows, idx, n)
        close = (vals[:, k] - vals[:, k - 1]) <= tol
        out += [(step, int(i)) for i in torch.nonzero(close).flatten()]
    return out


def follow(params0: Mapping[str, torch.Tensor], rows: torch.Tensor,
           labels: torch.Tensor, ids: torch.Tensor,
           batches: List[torch.Tensor], *, pos_weight: float, k: int,
           lr: float, wd: float, dropout: float, generator_seed: int,
           n_hidden: int = 2, dtype=torch.float64, kind: str = "exact",
           fault: Optional[str] = None, swaps=()) -> Dict:
    """→ {"losses": [float] a step, "given1": {name: the first update's
    input}, "grad1": {name: the first gradient}, "change": {name: θ after
    the last step − θ0}}."""
    dev = rows.device
    p = {n: t.detach().to(dtype).clone().requires_grad_(True)
         for n, t in params0.items()}
    start = {n: t.detach().clone() for n, t in p.items()}
    state = RF.new_state(p)
    gen = torch.Generator(device=dev).manual_seed(int(generator_seed))
    n = rows.shape[0]
    out = {"losses": [], "given1": None, "grad1": None}
    for step, b in enumerate(batches):
        q = rows[b]
        mask = RS.mask_rows(ids, n, ids[b], "batch")
        if kind == "exact":
            nb = RS.nearest(q, rows, mask, k + 1)[2]
            for s, i in swaps:
                if s == step:
                    nb[i, k - 1] = nb[i, k]
            nb = nb[:, :k]
        else:
            nb = RS.scan(q, rows, mask, k, kind)[1]
        valid = torch.ones(len(b), dtype=torch.bool, device=dev)
        if fault == "half_batch":
            valid[len(b) // 2:] = False
        logits = RF.forward(p, rows[nb].to(dtype), q.to(dtype),
                            n_hidden=n_hidden, kind=kind, dropout=dropout,
                            generator=gen)
        if fault == "altered":
            logits = logits + (torch.arange(len(b), device=dev) == 0)
        loss = RF.bce(logits, labels[b].to(dtype), pos_weight, valid)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        out["losses"].append(float(loss.detach()))
        if fault == "unchanged":
            given = {name: torch.zeros_like(t) for name, t in p.items()}
        else:
            given = RF.adam_step(p, grads, state, lr, wd)
        if step == 0:
            out["given1"], out["grad1"] = given, grads
    out["change"] = {name: (t.detach() - start[name]) for name, t in p.items()}
    return out


def pos_weight_of(labels: torch.Tensor) -> float:
    """(negatives + 1) / (positives + 1), clipped to [0.1, 10]."""
    pos = float((labels == 1.0).sum())
    neg = float((labels == 0.0).sum())
    return min(max((neg + 1.0) / (pos + 1.0), 0.1), 10.0)
