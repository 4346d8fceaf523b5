"""RADAD fusion model: projection over retrieved neighbors, query/neighbor
fusion, detection MLP head.

Counterpart: ``radad_tpu/models/fusion.py`` (flax ``ProjectionLayer``,
``DetectionModel``, ``RADADModel``; reference projection.py:8-117,
detection_model.py:41-126, radad_model.py:9-41). Submodule names match the
flax parameter names so ``models/convert.py`` maps them one to one. Every
flax submodule is a torch module called as one (``Dense``, ``BatchNorm``,
``nn.LayerNorm``, ``Dropout``), so forward hooks see each output that
flax's ``capture_intermediates`` records (``models/introspect.py``).

In eval mode (``build_radad_model`` returns the model so) dropout is the
identity and BatchNorm uses its running statistics. In training mode
(``model.train()``):

- dropout follows the projection's LayerNorm and each hidden ReLU of the
  detection head; it keeps a value with probability ``1 - p`` and scales
  it by ``1 / (1 - p)``, drawing from the ``generator`` given to
  ``forward``;
- BatchNorm normalizes with the batch statistics as flax computes them
  (mean, and the biased variance ``E[x²] − E[x]²`` clamped at 0) and keeps
  them in ``last_stats``; ``commit_batch_stats`` then moves the running
  statistics flax's way, ``running = 0.9 · running + 0.1 · batch``, with the
  biased variance. ``torch.nn.BatchNorm1d``'s own training update takes the
  unbiased variance, so it is not used. Committing apart from the forward
  keeps a rematerialized forward (``torch.utils.checkpoint``) from moving
  the statistics twice.

With ``use_mixed_precision`` the model computes in ``compute_dtype``
(bf16), as flax's ``Dense(dtype=bf16, param_dtype=f32)``: the parameters
stay f32, each linear layer casts its input, weight and bias to bf16,
rounds the product to bf16 and adds the bias in bf16 (``dense``, the
encoders' ``linear``). The
neighbor softmax is f32 and its weights go to bf16; the weighted sum over
the neighbors adds in f32 and rounds to bf16 (``jnp.sum`` of bf16 does).
The projection's LayerNorm and the head's BatchNorm / LayerNorm take their
input in f32 (BatchNorm's batch statistics too) and their output goes back
to bf16; dropout works on the bf16 activations; the logits come back f32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from radad_tpu_torch.models.encoder_common import linear, rounded
from radad_tpu_torch.utils.device import compute_dtype

BN_MOMENTUM = 0.9  # flax nn.BatchNorm(momentum=0.9), fusion.py:126


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``Dense(dtype=x.dtype, param_dtype=f32)`` with ``lin``'s f32
    parameters (``encoder_common.linear``: outside f32 the product is
    rounded to x's dtype, then the bias is added in it)."""
    return linear(x, lin.weight, lin.bias)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - p``, kept values
    divided by ``1 - p`` (rounded to x's dtype first, as flax's Python
    scalar takes the array's dtype), the rest 0."""
    if p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / rounded(1.0 - p, x.dtype),
                       torch.zeros_like(x))


def batch_stats(x: torch.Tensor, stats_sum: Optional[Callable] = None):
    """flax ``_compute_stats`` over axis 0 (use_fast_variance): mean and
    ``max(0, E[x²] − E[x]²)``. ``stats_sum`` (a data-parallel step's
    differentiable sum over the ranks of the batch): the moments of the
    global batch, from the summed [Σx, Σx², rows]."""
    if stats_sum is None:
        mean = x.mean(0)
        return mean, torch.clamp_min(x.square().mean(0) - mean.square(), 0.0)
    f = x.shape[1]
    tot = stats_sum(torch.cat([x.sum(0), x.square().sum(0),
                               x.new_full((1,), x.shape[0])]))
    mean = tot[:f] / tot[-1]
    return mean, torch.clamp_min(tot[f:2 * f] / tot[-1] - mean.square(), 0.0)


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor,
               stats_sum: Optional[Callable] = None) -> torch.Tensor:
    """flax ``nn.BatchNorm`` forward: running statistics in eval mode, the
    batch's in training mode (kept in ``bn.last_stats`` for
    ``commit_batch_stats``); ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``."""
    if bn.training:
        mean, var = batch_stats(x, stats_sum)
        bn.last_stats = (mean.detach(), var.detach())
    else:
        mean, var = bn.running_mean, bn.running_var
    return (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


class Dense(nn.Linear):
    """``nn.Linear`` whose forward is ``dense``: called as a module, so a
    forward hook sees its output (flax ``Dense``'s ``__call__``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self, x)


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose forward is ``batch_norm`` (flax's
    statistics and update, not torch's)."""

    def forward(self, x: torch.Tensor,
                stats_sum: Optional[Callable] = None) -> torch.Tensor:
        return batch_norm(self, x, stats_sum)


class Dropout(nn.Module):
    """flax ``nn.Dropout`` as a module without parameters: ``dropout`` in
    training mode, the identity in eval mode."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.p, generator) if self.training else x


class ProjectionLayer(nn.Module):
    """Attention aggregation of K neighbor vectors → ``[B, output_dim]``."""

    def __init__(self, input_dim: int, hidden_dim: int = 256,
                 output_dim: int = 128, dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.attention_score = Dense(input_dim, hidden_dim)
        self.attention_final = Dense(hidden_dim, 1)
        self.cst_hidden = Dense(input_dim, hidden_dim)
        self.cst_output = Dense(hidden_dim, input_dim)
        self.weight_sum = Dense(input_dim, hidden_dim)
        self.normalization = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.drop = Dropout(dropout)
        self.unified_embedding = Dense(hidden_dim, output_dim)

    def _scores(self, x: torch.Tensor) -> torch.Tensor:
        """Scalar attention scores [B, K, 1] (projection.py:68-71)."""
        return self.attention_final(torch.tanh(self.attention_score(x)))

    def forward(self, neighbors: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        x = neighbors.to(dt)  # [B, K, D]
        scores = self._scores(x)
        # CST channel re-weighting path (projection.py:73-76)
        cst = self.cst_output(torch.relu(self.cst_hidden(x)))
        weights = torch.softmax(scores.float(), dim=1).to(dt)
        summed = (weights * cst).sum(1)  # [B, D]
        h = self.normalization(self.weight_sum(summed).float())
        return self.unified_embedding(self.drop(h.to(dt), generator))

    def attention_weights(self, neighbors: torch.Tensor) -> torch.Tensor:
        """Softmaxed neighbor attention [B, K, 1] in f32, for introspection
        (the flax ``ProjectionLayer.attention_weights``; projection.py:
        124-130)."""
        scores = self._scores(neighbors.to(self.compute_dtype))
        return torch.softmax(scores.float(), dim=1)


class DetectionModel(nn.Module):
    """MLP classifier head → spoof logits ``[B]``."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (64, 32),
                 use_batch_norm: bool = False, use_layer_norm: bool = True,
                 dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_batch_norm = use_batch_norm
        dims = [input_dim] + list(hidden_dims) + [1]
        self.linears = nn.ModuleList(
            Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))
        # same precedence as detection_model.py:54-59: BatchNorm wins
        if use_batch_norm:
            norms = [BatchNorm(h, eps=1e-5) for h in hidden_dims]
        elif use_layer_norm:
            norms = [nn.LayerNorm(h, eps=1e-5) for h in hidden_dims]
        else:
            norms = []
        self.norms = nn.ModuleList(norms)
        # flax builds a Dropout after each hidden ReLU only when dropout > 0
        self.drops = nn.ModuleList(
            Dropout(dropout) for _ in hidden_dims if dropout > 0)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                stats_sum: Optional[Callable] = None) -> torch.Tensor:
        dt = self.compute_dtype
        last = len(self.linears) - 1
        x = x.to(dt)
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < last:
                if self.use_batch_norm:
                    x = self.norms[i](x.float(), stats_sum).to(dt)
                elif len(self.norms):
                    x = self.norms[i](x.float()).to(dt)
                x = torch.relu(x)
                if len(self.drops):
                    x = self.drops[i](x, generator)
        return x.squeeze(-1).float()  # logits [B]

    @torch.no_grad()
    def commit_batch_stats(self) -> None:
        """Move each BatchNorm's running statistics toward the batch
        statistics of the last training forward, flax's way (momentum 0.9,
        biased variance), once."""
        for bn in self.norms if self.use_batch_norm else ():
            mean, var = bn.last_stats
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                                  + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                                 + (1 - BN_MOMENTUM) * var)
            bn.num_batches_tracked += 1


class RADADModel(nn.Module):
    """Retrieval-augmented detector: neighbors + query TPP vector → logit."""

    def __init__(self, tpp_dim: int, projection_hidden_dim: int = 256,
                 projection_output_dim: int = 128,
                 detection_hidden_dims: Sequence[int] = (64, 32),
                 use_batch_norm: bool = False, use_layer_norm: bool = True,
                 projection_dropout: float = 0.1,
                 detection_dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.projection_layer = ProjectionLayer(
            tpp_dim, projection_hidden_dim, projection_output_dim,
            projection_dropout, compute_dtype)
        self.fuse = Dense(tpp_dim + projection_output_dim,
                          projection_output_dim)
        self.detection_model = DetectionModel(
            projection_output_dim, detection_hidden_dims, use_batch_norm,
            use_layer_norm, detection_dropout, compute_dtype)

    def forward(self, neighbor_vecs: torch.Tensor, tpp_vecs: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                stats_sum: Optional[Callable] = None) -> torch.Tensor:
        """``neighbor_vecs [B, K, D]``, ``tpp_vecs [B, D]`` → logits ``[B]``
        (radad_model.py:32-41). ``generator``: dropout's draws in training
        mode; ``stats_sum``: BatchNorm's cross-rank sum (``batch_stats``)."""
        dt = self.compute_dtype
        proj = self.projection_layer(neighbor_vecs, generator)
        fused = self.fuse(torch.cat([tpp_vecs.to(dt), proj], dim=-1))
        return self.detection_model(fused, generator, stats_sum)


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
    in eval mode with its parameters frozen (serving), initialized from
    ``generator`` (seeded from ``config.random_seed`` when not given).
    Training calls ``.train()`` and ``requires_grad_(True)``. The
    parameters are f32; the forward runs in ``compute_dtype(config)``."""
    model = RADADModel(
        tpp_dim, config.projection_hidden_dim, config.projection_output_dim,
        tuple(config.detection_hidden_dims), config.use_batch_norm,
        config.use_layer_norm, config.projection_dropout,
        config.detection_dropout, compute_dtype(config))
    if generator is None:
        generator = torch.Generator().manual_seed(config.random_seed)
    init_radad_model(model, generator)
    return model.eval().requires_grad_(False)
