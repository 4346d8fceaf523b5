"""RADAD fusion model, eval-mode forward: projection over retrieved
neighbors, query/neighbor fusion, detection MLP head.

Counterpart: ``radad_tpu/models/fusion.py`` (flax ``ProjectionLayer``,
``DetectionModel``, ``RADADModel``; reference projection.py:8-117,
detection_model.py:41-126, radad_model.py:9-41). Submodule names match the
flax parameter names so ``models/convert.py`` maps them one to one.

Only the serving forward is ported: there is no dropout (it is the
identity in eval mode) and BatchNorm, when configured, uses its running
statistics. Training comes in a later slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class ProjectionLayer(nn.Module):
    """Attention aggregation of K neighbor vectors → ``[B, output_dim]``."""

    def __init__(self, input_dim: int, hidden_dim: int = 256,
                 output_dim: int = 128):
        super().__init__()
        self.attention_score = nn.Linear(input_dim, hidden_dim)
        self.attention_final = nn.Linear(hidden_dim, 1)
        self.cst_hidden = nn.Linear(input_dim, hidden_dim)
        self.cst_output = nn.Linear(hidden_dim, input_dim)
        self.weight_sum = nn.Linear(input_dim, hidden_dim)
        self.normalization = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.unified_embedding = nn.Linear(hidden_dim, output_dim)

    def forward(self, neighbors: torch.Tensor) -> torch.Tensor:
        # neighbors [B, K, D]; scores path (projection.py:68-71)
        scores = self.attention_final(torch.tanh(
            self.attention_score(neighbors)))  # [B, K, 1]
        # CST channel re-weighting path (projection.py:73-76)
        cst = self.cst_output(torch.relu(self.cst_hidden(neighbors)))
        weights = torch.softmax(scores.float(), dim=1).to(cst.dtype)
        summed = (weights * cst).sum(1)  # [B, D]
        h = self.normalization(self.weight_sum(summed).float())
        return self.unified_embedding(h)


class DetectionModel(nn.Module):
    """MLP classifier head → spoof logits ``[B]``."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (64, 32),
                 use_batch_norm: bool = False, use_layer_norm: bool = True):
        super().__init__()
        dims = [input_dim] + list(hidden_dims) + [1]
        self.linears = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        # same precedence as detection_model.py:54-59: BatchNorm wins
        if use_batch_norm:
            norms = [nn.BatchNorm1d(h, eps=1e-5) for h in hidden_dims]
        elif use_layer_norm:
            norms = [nn.LayerNorm(h, eps=1e-5) for h in hidden_dims]
        else:
            norms = []
        self.norms = nn.ModuleList(norms)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.linears) - 1
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < last:
                if len(self.norms):
                    x = self.norms[i](x.float())
                x = torch.relu(x)
        return x.squeeze(-1).float()  # logits [B]


class RADADModel(nn.Module):
    """Retrieval-augmented detector: neighbors + query TPP vector → logit."""

    def __init__(self, tpp_dim: int, projection_hidden_dim: int = 256,
                 projection_output_dim: int = 128,
                 detection_hidden_dims: Sequence[int] = (64, 32),
                 use_batch_norm: bool = False, use_layer_norm: bool = True):
        super().__init__()
        self.projection_layer = ProjectionLayer(
            tpp_dim, projection_hidden_dim, projection_output_dim)
        self.fuse = nn.Linear(tpp_dim + projection_output_dim,
                              projection_output_dim)
        self.detection_model = DetectionModel(
            projection_output_dim, detection_hidden_dims, use_batch_norm,
            use_layer_norm)

    def forward(self, neighbor_vecs: torch.Tensor,
                tpp_vecs: torch.Tensor) -> torch.Tensor:
        """``neighbor_vecs [B, K, D]``, ``tpp_vecs [B, D]`` → logits ``[B]``
        (radad_model.py:32-41)."""
        proj = self.projection_layer(neighbor_vecs)
        fused = self.fuse(torch.cat([tpp_vecs, proj], dim=-1))
        return self.detection_model(fused)


@torch.no_grad()
def init_radad_model(model: RADADModel, generator: torch.Generator
                     ) -> RADADModel:
    """Seeded init with the reference's schemes: Xavier-uniform weights
    and zero biases in the projection layer (projection.py:58-66),
    He-uniform in the detection head (detection_model.py:93-105), torch's
    Linear default for the fuse layer (radad_model.py:26)."""
    def uniform_(t, bound):
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                              generator=generator))

    for lin in model.projection_layer.modules():
        if isinstance(lin, nn.Linear):
            fan_out, fan_in = lin.weight.shape
            uniform_(lin.weight, math.sqrt(6.0 / (fan_in + fan_out)))
            lin.bias.zero_()
    for lin in model.detection_model.linears:
        uniform_(lin.weight, math.sqrt(6.0 / lin.weight.shape[1]))
        lin.bias.zero_()
    fan_in = model.fuse.weight.shape[1]
    uniform_(model.fuse.weight, 1.0 / math.sqrt(fan_in))
    uniform_(model.fuse.bias, 1.0 / math.sqrt(fan_in))
    return model


def build_radad_model(config, tpp_dim: int,
                      generator: torch.Generator = None) -> RADADModel:
    """Factory wiring the Config into the model (radad_model.py:17-27),
    in eval mode, initialized from ``generator`` (seeded from
    ``config.random_seed`` when not given)."""
    if config.use_mixed_precision:
        raise NotImplementedError("mixed-precision fusion model: not yet "
                                  "ported")
    model = RADADModel(
        tpp_dim, config.projection_hidden_dim, config.projection_output_dim,
        tuple(config.detection_hidden_dims), config.use_batch_norm,
        config.use_layer_norm)
    if generator is None:
        generator = torch.Generator().manual_seed(config.random_seed)
    init_radad_model(model, generator)
    return model.eval().requires_grad_(False)
