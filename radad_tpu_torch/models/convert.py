"""Weights bridge: JAX parameters (as numpy arrays) → the port's modules.

Counterpart: none in ``radad_tpu``. It lets the same weights run through
both packages (the parity tests do this) and lets a model trained with the
JAX package serve from the port. Layout changes:

  * linear weights: ``[in, out]`` in JAX → ``[out, in]`` here;
  * conv kernels: ``[K, C_in/g, C_out]`` in JAX → ``[C_out, C_in/g, K]``;
  * the encoder's layers are stacked on axis 0 in JAX (for ``lax.scan``)
    and a ``ModuleList`` here.

Inputs are nested dicts of array-likes (``np.asarray`` is applied to each
leaf), e.g. ``jax.tree_util.tree_map(np.asarray, params)``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from radad_tpu_torch.models.fusion import RADADModel
from radad_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from radad_tpu_torch.models.wavlm import WavLMConfig, WavLMModel


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32))


@torch.no_grad()
def encoder_from_jax(params: Mapping, cfg: Wav2Vec2Config,
                     model: Wav2Vec2Model = None) -> Wav2Vec2Model:
    """``radad_tpu.models.wav2vec2`` params pytree (from ``init_params``
    or ``hf_convert.convert_wav2vec2``) → ``Wav2Vec2Model`` (or into
    ``model``, the shared skeleton of a WavLM)."""
    if model is None:
        model = Wav2Vec2Model(cfg)
    for layer, src in zip(model.conv_layers, params["conv_layers"]):
        layer["kernel"].copy_(_t(src["kernel"]).permute(2, 1, 0))
        for key in ("bias", "norm_scale", "norm_bias"):
            if key in layer:
                layer[key].copy_(_t(src[key]))
    fp = params["feat_proj"]
    model.feat_proj["ln_scale"].copy_(_t(fp["ln_scale"]))
    model.feat_proj["ln_bias"].copy_(_t(fp["ln_bias"]))
    model.feat_proj["kernel"].copy_(_t(fp["kernel"]).T)
    model.feat_proj["bias"].copy_(_t(fp["bias"]))
    model.pos_conv["kernel"].copy_(
        _t(params["pos_conv"]["kernel"]).permute(2, 1, 0))
    model.pos_conv["bias"].copy_(_t(params["pos_conv"]["bias"]))
    model.encoder_ln["scale"].copy_(_t(params["encoder_ln"]["scale"]))
    model.encoder_ln["bias"].copy_(_t(params["encoder_ln"]["bias"]))
    stacked = params["layers"]
    for i, layer in enumerate(model.layers):
        for key, p in layer["attn"].items():
            v = _t(stacked["attn"][key][i])
            p.copy_(v.T if key.endswith("w") else v)
        for key, p in layer["ffn"].items():
            v = _t(stacked["ffn"][key][i])
            p.copy_(v.T if key.startswith("w") else v)
        for ln in ("ln1", "ln2"):
            layer[ln]["scale"].copy_(_t(stacked[ln]["scale"][i]))
            layer[ln]["bias"].copy_(_t(stacked[ln]["bias"][i]))
    return model


@torch.no_grad()
def wavlm_from_jax(params: Mapping, cfg: WavLMConfig) -> WavLMModel:
    """``radad_tpu.models.wavlm`` params pytree (from ``init_params`` or
    ``hf_convert.convert_wavlm``) → ``WavLMModel``: the wav2vec2 skeleton
    plus ``rel_attn_embed`` and the stacked ``gate_w [L, hd, 8]``,
    ``gate_b``, ``gate_const``."""
    model = encoder_from_jax(params, cfg, WavLMModel(cfg))
    model.rel_attn_embed.copy_(_t(params["rel_attn_embed"]))
    stacked = params["layers"]
    for i, layer in enumerate(model.layers):
        layer["gate"]["w"].copy_(_t(stacked["gate_w"][i]).T)
        layer["gate"]["b"].copy_(_t(stacked["gate_b"][i]))
        layer["gate"]["const"].copy_(_t(stacked["gate_const"][i]))
    return model


@torch.no_grad()
def fusion_from_flax(model: RADADModel, variables: Mapping) -> RADADModel:
    """Load flax ``RADADModel`` variables (``{"params": ...}`` plus
    ``"batch_stats"`` when the detection head uses BatchNorm) into
    ``model`` in place; returns it."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def dense(mod, p):
        mod.weight.copy_(_t(p["kernel"]).T)
        mod.bias.copy_(_t(p["bias"]))

    def norm(mod, p, s=None):
        mod.weight.copy_(_t(p["scale"]))
        mod.bias.copy_(_t(p["bias"]))
        if s is not None:
            mod.running_mean.copy_(_t(s["mean"]))
            mod.running_var.copy_(_t(s["var"]))

    proj = params["projection_layer"]
    pl = model.projection_layer
    for name in ("attention_score", "attention_final", "cst_hidden",
                 "cst_output", "weight_sum", "unified_embedding"):
        dense(getattr(pl, name), proj[name])
    norm(pl.normalization, proj["normalization"])
    dense(model.fuse, params["fuse"])
    det = params["detection_model"]
    det_stats = stats.get("detection_model", {})
    for i, lin in enumerate(model.detection_model.linears):
        dense(lin, det[f"linear_{i}"])
    for i, nrm in enumerate(model.detection_model.norms):
        norm(nrm, det[f"norm_{i}"], det_stats.get(f"norm_{i}"))
    return model
