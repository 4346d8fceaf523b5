"""HF checkpoint → port encoder modules (wav2vec2, HuBERT, WavLM,
Whisper).

Counterpart: ``radad_tpu/models/hf_convert.py`` (``convert_wav2vec2``,
``convert_wavlm``, ``convert_whisper_encoder``, ``load_state_dict``). HF
state dicts are already in PyTorch's layouts, so weights copy as they are;
the weight-normed positional conv is materialized into a plain kernel.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from radad_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from radad_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from radad_tpu_torch.models.whisper import WhisperConfig, WhisperEncoder


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def _weight_normed_conv(sd: Mapping, prefix: str) -> torch.Tensor:
    """Materialize torch weight_norm(dim=2): w = g * v / ||v||_{dims 0,1}."""
    if f"{prefix}.parametrizations.weight.original0" in sd:
        g = _t(sd[f"{prefix}.parametrizations.weight.original0"])
        v = _t(sd[f"{prefix}.parametrizations.weight.original1"])
    else:
        g = _t(sd[f"{prefix}.weight_g"])
        v = _t(sd[f"{prefix}.weight_v"])
    norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
    return g * v / norm.clamp_min(1e-12)  # [out, in/groups, k]


def _put(sd: Mapping, param, key: str) -> None:
    param.copy_(_t(sd[key]).reshape(param.shape))


@torch.no_grad()
def convert_wav2vec2(sd: Mapping, cfg: Wav2Vec2Config,
                     model: Wav2Vec2Model = None) -> Wav2Vec2Model:
    """HF Wav2Vec2Model / HubertModel state dict → ``Wav2Vec2Model`` (or
    into ``model``, the shared skeleton of a WavLM)."""
    if model is None:
        model = Wav2Vec2Model(cfg)

    def put(param, key):
        _put(sd, param, key)

    for i, layer in enumerate(model.conv_layers):
        pre = f"feature_extractor.conv_layers.{i}"
        put(layer["kernel"], f"{pre}.conv.weight")
        if "bias" in layer:
            put(layer["bias"], f"{pre}.conv.bias")
        if "norm_scale" in layer:
            put(layer["norm_scale"], f"{pre}.layer_norm.weight")
            put(layer["norm_bias"], f"{pre}.layer_norm.bias")
    fp = model.feat_proj
    put(fp["ln_scale"], "feature_projection.layer_norm.weight")
    put(fp["ln_bias"], "feature_projection.layer_norm.bias")
    put(fp["kernel"], "feature_projection.projection.weight")
    put(fp["bias"], "feature_projection.projection.bias")
    model.pos_conv["kernel"].copy_(
        _weight_normed_conv(sd, "encoder.pos_conv_embed.conv"))
    put(model.pos_conv["bias"], "encoder.pos_conv_embed.conv.bias")
    put(model.encoder_ln["scale"], "encoder.layer_norm.weight")
    put(model.encoder_ln["bias"], "encoder.layer_norm.bias")
    names = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}
    for i, layer in enumerate(model.layers):
        pre = f"encoder.layers.{i}"
        for short, hf in names.items():
            put(layer["attn"][f"{short}w"], f"{pre}.attention.{hf}.weight")
            put(layer["attn"][f"{short}b"], f"{pre}.attention.{hf}.bias")
        for ln, hf in (("ln1", "layer_norm"), ("ln2", "final_layer_norm")):
            put(layer[ln]["scale"], f"{pre}.{hf}.weight")
            put(layer[ln]["bias"], f"{pre}.{hf}.bias")
        ffn = layer["ffn"]
        put(ffn["w1"], f"{pre}.feed_forward.intermediate_dense.weight")
        put(ffn["b1"], f"{pre}.feed_forward.intermediate_dense.bias")
        put(ffn["w2"], f"{pre}.feed_forward.output_dense.weight")
        put(ffn["b2"], f"{pre}.feed_forward.output_dense.bias")
    return model


@torch.no_grad()
def convert_wavlm(sd: Mapping, cfg: WavLMConfig) -> WavLMModel:
    """HF WavLMModel state dict → ``WavLMModel``: the wav2vec2 skeleton
    plus ``rel_attn_embed`` (layer 0 owns it) and each layer's
    ``gru_rel_pos_linear`` / ``gru_rel_pos_const``."""
    model = convert_wav2vec2(sd, cfg, WavLMModel(cfg))
    _put(sd, model.rel_attn_embed,
         "encoder.layers.0.attention.rel_attn_embed.weight")
    for i, layer in enumerate(model.layers):
        pre = f"encoder.layers.{i}.attention"
        _put(sd, layer["gate"]["w"], f"{pre}.gru_rel_pos_linear.weight")
        _put(sd, layer["gate"]["b"], f"{pre}.gru_rel_pos_linear.bias")
        _put(sd, layer["gate"]["const"], f"{pre}.gru_rel_pos_const")
    return model


@torch.no_grad()
def convert_whisper_encoder(sd: Mapping, cfg: WhisperConfig
                            ) -> WhisperEncoder:
    """HF WhisperModel (or WhisperEncoder) state dict → ``WhisperEncoder``.
    Keys may carry ``model.encoder.`` or ``encoder.`` or no prefix."""
    for pref in ("model.encoder.", "encoder.", ""):
        if f"{pref}conv1.weight" in sd:
            break
    else:
        raise KeyError("no whisper encoder keys found in state dict")
    model = WhisperEncoder(cfg)

    def put(param, key):
        _put(sd, param, pref + key)

    for name in ("conv1", "conv2"):
        put(getattr(model, name)["kernel"], f"{name}.weight")
        put(getattr(model, name)["bias"], f"{name}.bias")
    put(model.pos_embed, "embed_positions.weight")
    put(model.final_ln["scale"], "layer_norm.weight")
    put(model.final_ln["bias"], "layer_norm.bias")
    for i, layer in enumerate(model.layers):
        pre = f"layers.{i}"
        attn = layer["attn"]
        for short, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                          ("o", "out_proj")):
            put(attn[f"{short}w"], f"{pre}.self_attn.{hf}.weight")
            if f"{short}b" in attn:
                put(attn[f"{short}b"], f"{pre}.self_attn.{hf}.bias")
        for ln, hf in (("ln1", "self_attn_layer_norm"),
                       ("ln2", "final_layer_norm")):
            put(layer[ln]["scale"], f"{pre}.{hf}.weight")
            put(layer[ln]["bias"], f"{pre}.{hf}.bias")
        ffn = layer["ffn"]
        for w, b, hf in (("w1", "b1", "fc1"), ("w2", "b2", "fc2")):
            put(ffn[w], f"{pre}.{hf}.weight")
            put(ffn[b], f"{pre}.{hf}.bias")
    return model


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a torch ``.bin``/``.pt`` or ``.safetensors`` checkpoint from
    local disk into a flat name → tensor dict."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)
