"""Model introspection: parameter and FLOP accounting, attention weights,
activation capture, gradient-based feature importance, BatchNorm folding,
probability helpers.

Counterpart: ``radad_tpu/models/introspect.py`` (reference
projection.py:124-130,155-160; detection_model.py:148-237). Each function
takes the port's ``RADADModel`` in place of flax's ``(model, variables)``.

The forward runs as the JAX package's introspection runs it: eval mode
(dropout the identity, BatchNorm on its running statistics), whatever mode
the caller's model is in; the mode is restored afterwards. Activation
capture uses forward hooks, each output keyed by its flax path
(``"detection_model/linear_0/__call__"``), as flax's
``capture_intermediates`` keys it; input saliency uses autograd with
respect to the query features alone.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from radad_tpu_torch.models.fusion import RADADModel


def parameter_count(model: RADADModel) -> Dict[str, int]:
    """Parameters per top-level submodule (``projection_layer``, ``fuse``,
    ``detection_model``; BatchNorm's running statistics are buffers, as
    flax keeps them out of ``params``) and in all."""
    out = {name: sum(p.numel() for p in child.parameters())
           for name, child in model.named_children()}
    out["total"] = sum(out.values())
    return out


def projection_flops(batch: int, k: int, input_dim: int, hidden_dim: int,
                     output_dim: int) -> int:
    """Forward FLOPs of the projection layer (projection.py:155-160's
    accounting, multiply-adds counted as 2 operations)."""
    per_neighbor = 2 * (input_dim * hidden_dim + hidden_dim  # attn score
                        + input_dim * hidden_dim + hidden_dim * input_dim)  # cst
    head = 2 * (input_dim * hidden_dim + hidden_dim * output_dim)
    return batch * (k * per_neighbor + head)


def detection_flops(batch: int, dims) -> int:
    dims = list(dims)
    return batch * sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def model_complexity(model: RADADModel, batch: int = 1) -> Dict:
    """Complexity report (detection_model.py:212-237 analogue): parameters
    per submodule, forward FLOPs at K = 5 neighbors, parameter bytes in
    f32. The dimensions are read from the module's layers."""
    proj = model.projection_layer
    d = proj.attention_score.in_features
    hidden = proj.attention_score.out_features
    out_dim = proj.unified_embedding.out_features
    det_hidden = [lin.out_features for lin in model.detection_model.linears
                  ][:-1]
    counts = parameter_count(model)
    flops = (projection_flops(batch, 5, d, hidden, out_dim)
             + 2 * batch * (d + out_dim) * out_dim  # fuse
             + detection_flops(batch, [out_dim, *det_hidden, 1]))
    return {
        "parameters": counts,
        "forward_flops": int(flops),
        "param_bytes_f32": counts["total"] * 4,
    }


@contextlib.contextmanager
def _eval_mode(model: RADADModel):
    """The model in eval mode inside the block, its own mode after."""
    was = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was)


def attention_weights(model: RADADModel, neighbors: torch.Tensor
                      ) -> torch.Tensor:
    """Softmaxed neighbor-attention weights [B, K, 1] (projection.py:
    124-130), from the f32 parameters in f32 whatever the model's compute
    dtype, as the JAX package's function computes them."""
    p = model.projection_layer
    with torch.no_grad():
        x = neighbors.float()
        scores = F.linear(torch.tanh(F.linear(
            x, p.attention_score.weight, p.attention_score.bias)),
            p.attention_final.weight, p.attention_final.bias)
        return torch.softmax(scores, dim=1)


def _flax_paths(model: RADADModel) -> Dict[str, str]:
    """{port submodule name: its flax path}: the model itself is "", the
    detection head's ``linears.i`` / ``norms.i`` / ``drops.i`` are
    ``linear_i`` / ``norm_i`` / ``Dropout_i``, the projection's ``drop``
    is ``Dropout_0``; every other name is flax's."""
    rename = {"linears": "linear", "norms": "norm", "drops": "Dropout"}
    out = {}
    for name, _ in model.named_modules():
        parts = name.split(".") if name else []
        if parts[-1:] in (["linears"], ["norms"], ["drops"]):
            continue  # the ModuleLists themselves: flax has no such level
        if parts[-1:] == ["drop"]:
            parts[-1] = "Dropout_0"
        elif len(parts) >= 2 and parts[-2] in rename:
            parts[-2:] = [f"{rename[parts[-2]]}_{parts[-1]}"]
        out[name] = "/".join(parts)
    return out


def activations(model: RADADModel, neighbors: torch.Tensor,
                tpp: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every submodule's output of one eval forward (detection_model.py:
    171-190 analogue), keyed as flax's ``capture_intermediates`` keys it:
    ``"<flax path>/__call__"``, the whole model ``"__call__"``, in the
    order the outputs complete."""
    flat = {}
    handles = []

    def hook(path):
        key = f"{path}/__call__" if path else "__call__"

        def record(_module, _args, out):
            flat[key] = out
        return record

    modules = dict(model.named_modules())
    try:
        for name, path in _flax_paths(model).items():
            handles.append(modules[name].register_forward_hook(hook(path)))
        with _eval_mode(model), torch.no_grad():
            model(neighbors, tpp)
    finally:
        for h in handles:
            h.remove()
    return flat


def feature_importance(model: RADADModel, neighbors: torch.Tensor,
                       tpp: torch.Tensor) -> torch.Tensor:
    """|∂logit/∂tpp| averaged over the batch: gradient-based input
    importance (detection_model.py:192-210 analogue, applied to the fused
    model's query features). Autograd with respect to ``tpp`` alone; no
    parameter gradient is kept."""
    t = tpp.detach().float().requires_grad_(True)
    with _eval_mode(model), torch.enable_grad():
        (g,) = torch.autograd.grad(model(neighbors, t).sum(), t)
    return g.abs().mean(0)


@torch.no_grad()
def fuse_batch_norm(model: RADADModel) -> RADADModel:
    """A new model whose detection-head BatchNorms are folded into the
    Dense before each (detection_model.py:239-270's fuse_inference_model
    analogue); ``model`` is left as it is.

    For y = BN(xW + b):  W' = W·(γ/σ),  b' = (b − μ)·(γ/σ) + β, where
    σ = √(var + ε). Each norm becomes the identity (weight 1, bias 0,
    running mean 0, running var 1 − ε, so that √(var + ε) = 1): the
    eval-mode forward is unchanged up to rounding. A head without
    BatchNorm comes back as an unchanged copy."""
    fused = copy.deepcopy(model)
    det = fused.detection_model
    if not det.use_batch_norm:
        return fused
    for lin, bn in zip(det.linears, det.norms):  # norm_i follows linear_i
        factor = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        lin.weight.mul_(factor[:, None])
        lin.bias.copy_((lin.bias - bn.running_mean) * factor + bn.bias)
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)
    return fused


def predict_proba(model: RADADModel, neighbors: torch.Tensor,
                  tpp: torch.Tensor) -> torch.Tensor:
    """σ(logit) → P(spoof) per clip (detection_model.py:148-156)."""
    with _eval_mode(model), torch.no_grad():
        return torch.sigmoid(model(neighbors, tpp))


def predict_batch_proba(model: RADADModel, neighbors: torch.Tensor,
                        tpp: torch.Tensor, chunk: int = 256) -> np.ndarray:
    """Chunked ``predict_proba`` for large batches
    (detection_model.py:158-169) → numpy."""
    outs = []
    for i in range(0, neighbors.shape[0], chunk):
        outs.append(predict_proba(model, neighbors[i:i + chunk],
                                  tpp[i:i + chunk]).cpu().numpy())
    return np.concatenate(outs)
