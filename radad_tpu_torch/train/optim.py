"""Optimizer: per-group clip + weight decay + Adam, and the pos-weighted
BCE.

Counterpart: ``radad_tpu/train/optim.py`` (one ``optax.multi_transform``
over three groups). The parameters split into three groups by their
top-level submodule, ``projection_layer``, ``fuse`` and
``detection_model`` (any other name goes to ``fuse``), and each group
runs, on its own:

    clip_by_global_norm(1.0) → + weight_decay · θ → Adam(0.9, 0.999,
    eps 1e-8 outside the square root, bias-corrected) → · (−lr)

The clip is optax's rule: ``g`` unchanged while ``‖g‖ < 1``, else
``g / ‖g‖``. ``torch.nn.utils.clip_grad_norm_`` divides by ``‖g‖ + 1e-6``
and is not used.

``GroupAdam.state`` holds each group's ``count``, ``mu`` and ``nu`` (by
parameter name); the checkpoint stores it and
``models/convert.py::adam_state_from_optax`` fills it from a JAX state.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

GROUPS = ("projection_layer", "fuse", "detection_model")


def group_of(name: str) -> str:
    """Group of a parameter named ``name`` (``model.named_parameters()``)."""
    top = name.split(".", 1)[0]
    return top if top in GROUPS else "fuse"


def _global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``tensors``."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(tensors))))


def group_grad_norms(grads: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Global gradient norm per group, taken before the clip (0 for a
    group without parameters)."""
    norms = {}
    for g in GROUPS:
        members = [t for n, t in grads.items() if group_of(n) == g]
        norms[g] = (_global_norm(members) if members else
                    torch.zeros((), device=next(iter(grads.values())).device))
    return norms


def _clip(tensors, norm: torch.Tensor, max_norm: float):
    """optax ``clip_by_global_norm``: every tensor unchanged when their
    global ``norm`` is below ``max_norm``, else ``t / (norm / max_norm)``
    (optax's ``t / norm * max_norm``, the same numbers at ``max_norm`` 1)."""
    denom = torch.where(norm < max_norm, torch.ones_like(norm),
                        norm / max_norm)
    return torch._foreach_div(tensors, denom)


class GroupAdam:
    """The per-group chain on a model's trainable parameters, applied in
    place by :meth:`step`. ``state`` is ``{group: {"count": int32 0-d,
    "mu": {name: tensor}, "nu": {name: tensor}}}`` once :meth:`init` ran."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.scale_by_adam in the reference
    clip_norm = 1.0  # optax.clip_by_global_norm in the reference

    def __init__(self, learning_rate: float, weight_decay: float):
        self.lr = float(learning_rate)
        self.wd = float(weight_decay)
        self.state: Optional[Dict[str, Dict]] = None

    def init(self, params: Mapping[str, torch.Tensor]) -> None:
        """Zero moments and counts for ``params`` (name → tensor)."""
        state = {}
        for g in GROUPS:
            members = {n: p for n, p in params.items() if group_of(n) == g}
            dev = next(iter(params.values())).device
            state[g] = {
                "count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": {n: torch.zeros_like(p) for n, p in members.items()},
                "nu": {n: torch.zeros_like(p) for n, p in members.items()}}
        self.state = state

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update of every group: ``params`` (name → parameter) are
        written in place from ``grads`` (name → gradient). Each line runs
        over all of a group's tensors at once (``torch._foreach_*``), in
        optax's order of operations. Returns ``group_grad_norms(grads)``,
        the norms the clip used."""
        norms = group_grad_norms(grads)
        for g in GROUPS:
            st = self.state[g]
            names = list(st["mu"])
            if not names:
                continue
            ps = [params[n] for n in names]
            u = _clip([grads[n] for n in names], norms[g], self.clip_norm)
            u = torch._foreach_add(u, torch._foreach_mul(ps, self.wd))
            mu = torch._foreach_add(
                torch._foreach_mul(u, 1 - self.b1),
                torch._foreach_mul(list(st["mu"].values()), self.b1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(u, u), 1 - self.b2),
                torch._foreach_mul(list(st["nu"].values()), self.b2))
            st["mu"], st["nu"] = dict(zip(names, mu)), dict(zip(names, nu))
            st["count"] += 1
            count = st["count"].float()
            c1 = 1 - torch.pow(self.b1, count)
            c2 = 1 - torch.pow(self.b2, count)
            den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
            torch._foreach_add_(den, self.eps)
            step = torch._foreach_div(torch._foreach_div(mu, c1), den)
            torch._foreach_add_(ps, torch._foreach_mul(step, -self.lr))
        return norms

    def state_dict(self) -> Dict[str, Dict]:
        return self.state

    def load_state_dict(self, state: Mapping[str, Mapping],
                        device=None) -> None:
        """A copy of ``state`` (on ``device``): later steps leave the
        source untouched."""
        def own(t):
            return t.to(device, copy=True)

        self.state = {g: {"count": own(state[g]["count"]),
                          "mu": {n: own(t) for n, t in state[g]["mu"].items()},
                          "nu": {n: own(t) for n, t in state[g]["nu"].items()}}
                      for g in GROUPS}


def pos_weighted_bce(logits: torch.Tensor, labels: torch.Tensor,
                     pos_weight: float,
                     valid: Optional[torch.Tensor] = None,
                     count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCE with logits and positive-class weighting,
    ``-[w·y·log σ(x) + (1-y)·log(1-σ(x))]``, mean over the ``valid`` rows
    (over all rows when ``valid`` is None). ``count`` replaces the number
    of valid rows as the divisor: a data-parallel rank's share of the
    global batch's mean."""
    logits = logits.float()
    labels = labels.float()
    per = -(pos_weight * labels * torch.nn.functional.logsigmoid(logits)
            + (1.0 - labels) * torch.nn.functional.logsigmoid(-logits))
    if valid is None:
        return per.mean()
    valid = valid.float()
    count = valid.sum() if count is None else count
    return (per * valid).sum() / count.clamp_min(1.0)
