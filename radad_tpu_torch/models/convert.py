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
from radad_tpu_torch.models.whisper import WhisperConfig, WhisperEncoder


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32))


def _layers_from_jax(layers, stacked: Mapping) -> None:
    """The transformer layers' attn, ffn, ln1 and ln2 from JAX's layers
    stacked on axis 0 (linear weights transposed)."""
    for i, layer in enumerate(layers):
        for key, p in layer["attn"].items():
            v = _t(stacked["attn"][key][i])
            p.copy_(v.T if key.endswith("w") else v)
        for key, p in layer["ffn"].items():
            v = _t(stacked["ffn"][key][i])
            p.copy_(v.T if key.startswith("w") else v)
        for ln in ("ln1", "ln2"):
            layer[ln]["scale"].copy_(_t(stacked[ln]["scale"][i]))
            layer[ln]["bias"].copy_(_t(stacked[ln]["bias"][i]))


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
    _layers_from_jax(model.layers, params["layers"])
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
def whisper_from_jax(params: Mapping, cfg: WhisperConfig) -> WhisperEncoder:
    """``radad_tpu.models.whisper`` params pytree (from ``init_params`` or
    ``hf_convert.convert_whisper_encoder``; ``attn.kb`` is None there) →
    ``WhisperEncoder``."""
    model = WhisperEncoder(cfg)
    for name in ("conv1", "conv2"):
        conv = getattr(model, name)
        conv["kernel"].copy_(_t(params[name]["kernel"]).permute(2, 1, 0))
        conv["bias"].copy_(_t(params[name]["bias"]))
    model.pos_embed.copy_(_t(params["pos_embed"]))
    model.final_ln["scale"].copy_(_t(params["final_ln"]["scale"]))
    model.final_ln["bias"].copy_(_t(params["final_ln"]["bias"]))
    _layers_from_jax(model.layers, params["layers"])
    return model


def _fusion_leaves(model: RADADModel):
    """(flax path, the port's parameter name, transpose) for every
    parameter of the fusion model: Dense kernels ``[in, out]`` become
    ``weight [out, in]``; LayerNorm and BatchNorm ``scale`` is ``weight``."""
    proj = ("attention_score", "attention_final", "cst_hidden", "cst_output",
            "weight_sum", "unified_embedding")
    dense = [(("projection_layer", n), f"projection_layer.{n}")
             for n in proj]
    dense.append((("fuse",), "fuse"))
    dense += [(("detection_model", f"linear_{i}"),
               f"detection_model.linears.{i}")
              for i in range(len(model.detection_model.linears))]
    norms = [(("projection_layer", "normalization"),
              "projection_layer.normalization")]
    norms += [(("detection_model", f"norm_{i}"),
               f"detection_model.norms.{i}")
              for i in range(len(model.detection_model.norms))]
    for path, name in dense:
        yield path + ("kernel",), f"{name}.weight", True
        yield path + ("bias",), f"{name}.bias", False
    for path, name in norms:
        yield path + ("scale",), f"{name}.weight", False
        yield path + ("bias",), f"{name}.bias", False


def _at(tree: Mapping, path):
    for key in path:
        tree = tree[key]
    return tree


@torch.no_grad()
def fusion_from_flax(model: RADADModel, variables: Mapping) -> RADADModel:
    """Load flax ``RADADModel`` variables (``{"params": ...}`` plus
    ``"batch_stats"`` when the detection head uses BatchNorm) into
    ``model`` in place; returns it."""
    params = dict(model.named_parameters())
    for path, name, transpose in _fusion_leaves(model):
        v = _t(_at(variables["params"], path))
        params[name].copy_(v.T if transpose else v)
    stats = variables.get("batch_stats", {}).get("detection_model", {})
    for i, nrm in enumerate(model.detection_model.norms):
        if f"norm_{i}" in stats:
            nrm.running_mean.copy_(_t(stats[f"norm_{i}"]["mean"]))
            nrm.running_var.copy_(_t(stats[f"norm_{i}"]["var"]))
    return model


def adam_state_from_optax(opt_state, model: RADADModel) -> dict:
    """The numpy pytree of the JAX optimizer's state
    (``radad_tpu/train/optim.py::make_optimizer``: an optax
    ``multi_transform`` whose state holds, per group, the chain's
    ``ScaleByAdamState(count, mu, nu)`` over the whole parameter tree, with
    the other groups' leaves masked) → ``GroupAdam.state`` for ``model``:
    ``{group: {"count", "mu": {name: tensor}, "nu": {name: tensor}}}``, so
    a run trained with JAX continues in the port."""
    from radad_tpu_torch.train.optim import GROUPS, group_of

    state = {}
    for group in GROUPS:
        chain = opt_state.inner_states[group].inner_state
        adam = next(s for s in chain if hasattr(s, "nu"))
        # a tensor of its own: GroupAdam.step adds to the count in place
        entry = {"count": torch.tensor(np.array(adam.count, np.int32)),
                 "mu": {}, "nu": {}}
        for path, name, transpose in _fusion_leaves(model):
            if group_of(name) != group:
                continue
            for key in ("mu", "nu"):
                v = _t(_at(getattr(adam, key), path))
                entry[key][name] = (v.T if transpose else v).contiguous()
        state[group] = entry
    return state
