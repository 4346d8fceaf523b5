"""Plain RADAD fusion model, its loss and its optimizer step.

The model (RADAD's projection, fuse and detection head): K neighbor
vectors are scored (Dense 256 → tanh → Dense 1, softmax over K) and
re-weighted (Dense 256 → ReLU → Dense D); their weighted sum goes through
Dense 256, LayerNorm (eps 1e-6), dropout and Dense 128; that is
concatenated after the query vector, Dense 128, then the head: Dense 64,
LayerNorm (eps 1e-5), ReLU, dropout, Dense 32, LayerNorm, ReLU, dropout,
Dense 1 → the logit. Dropout keeps a value with probability 1 - p and
divides it by 1 - p; its masks are ``torch.rand(shape, generator=g) >= p``,
drawn in the order above.

The loss is BCE with logits weighted by ``pos_weight`` on the positive
class, the mean over the valid rows. The optimizer runs on three groups of
parameters (``projection_layer``, ``fuse``, ``detection_model``), each:
clip by its global norm to 1 (unchanged below 1), add ``wd · θ``, Adam
(0.9, 0.999, eps 1e-8 outside the square root, bias-corrected), times
``-lr``.

Parameters are a mapping from the harness's names (``harness/weights.py``)
to tensors; ``kind`` rounds every product (``precision``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from reference import precision as P

GROUPS = ("projection_layer", "fuse", "detection_model")
B1, B2, EPS = 0.9, 0.999, 1e-8


def _dense(x, p, name, kind):
    return P.linear(x, p[f"{name}.weight"], p[f"{name}.bias"], kind)


def _dropout(x, rate: float, generator):
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def forward(p: Mapping[str, torch.Tensor], neighbors: torch.Tensor,
            query: torch.Tensor, *, n_hidden: int = 2, kind: str = "exact",
            dropout: float = 0.0,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``neighbors [B, K, D]``, ``query [B, D]`` → logits ``[B]``. Dropout
    runs only where ``dropout > 0``."""
    pl = "projection_layer"
    scores = _dense(torch.tanh(_dense(neighbors, p, f"{pl}.attention_score",
                                      kind)), p, f"{pl}.attention_final",
                    kind)
    cst = _dense(torch.relu(_dense(neighbors, p, f"{pl}.cst_hidden", kind)),
                 p, f"{pl}.cst_output", kind)
    summed = (torch.softmax(scores, dim=1) * cst).sum(1)
    h = _dense(summed, p, f"{pl}.weight_sum", kind)
    h = F.layer_norm(h, (h.shape[-1],), p[f"{pl}.normalization.weight"],
                     p[f"{pl}.normalization.bias"], 1e-6)
    if dropout > 0:
        h = _dropout(h, dropout, generator)
    proj = _dense(h, p, f"{pl}.unified_embedding", kind)
    x = _dense(torch.cat([query, proj], -1), p, "fuse", kind)
    for i in range(n_hidden + 1):
        x = _dense(x, p, f"detection_model.linears.{i}", kind)
        if i < n_hidden:
            x = F.layer_norm(x, (x.shape[-1],),
                             p[f"detection_model.norms.{i}.weight"],
                             p[f"detection_model.norms.{i}.bias"], 1e-5)
            x = torch.relu(x)
            if dropout > 0:
                x = _dropout(x, dropout, generator)
    return x.squeeze(-1)


def bce(logits, labels, pos_weight: float, valid) -> torch.Tensor:
    per = -(pos_weight * labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    valid = valid.to(per.dtype)
    return (per * valid).sum() / valid.sum().clamp_min(1.0)


def group_of(name: str) -> str:
    top = name.split(".", 1)[0]
    return top if top in GROUPS else "fuse"


def new_state(params: Mapping[str, torch.Tensor]) -> Dict:
    return {"count": 0,
            "mu": {n: torch.zeros_like(t) for n, t in params.items()},
            "nu": {n: torch.zeros_like(t) for n, t in params.items()}}


@torch.no_grad()
def adam_step(params: Dict[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
              state: Dict, lr: float, wd: float) -> Dict[str, torch.Tensor]:
    """One update of every group, in place on ``params``. → each leaf's
    update input (the clipped gradient plus ``wd · θ``)."""
    state["count"] += 1
    c1, c2 = 1 - B1 ** state["count"], 1 - B2 ** state["count"]
    given = {}
    for g in GROUPS:
        names = [n for n in params if group_of(n) == g]
        if not names:
            continue
        norm = torch.sqrt(sum(grads[n].square().sum() for n in names))
        div = torch.where(norm < 1.0, torch.ones_like(norm), norm)
        for n in names:
            u = grads[n] / div + wd * params[n]
            given[n] = u
            state["mu"][n] = (1 - B1) * u + B1 * state["mu"][n]
            state["nu"][n] = (1 - B2) * u * u + B2 * state["nu"][n]
            step = (state["mu"][n] / c1) / (torch.sqrt(state["nu"][n] / c2)
                                            + EPS)
            params[n] -= lr * step
    return given
