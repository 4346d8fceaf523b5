"""Frozen-encoder factory: wav2vec2 and HuBERT.

Counterpart: ``radad_tpu/models/encoder.py`` (``FrozenEncoder``,
``build_encoder``, ``resolve_arch_config``). Weights resolve from local
files only: ``<weights_dir>/<model-name-with-slashes-as-dashes>/
{model.safetensors, pytorch_model.bin}``, else the HF cache layout, else a
seeded random init at full width with a warning (the pipeline's mechanics,
retrieval and timing do not depend on the weights). WavLM and Whisper raise
"not yet ported".
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
from typing import Optional

import torch

from radad_tpu_torch.models import hf_convert, wav2vec2
from radad_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FrozenEncoder:
    """A frozen pretrained speech encoder: module + architecture."""

    name: str  # "wav2vec2" | "hubert"
    model_name: str  # HF-style id, e.g. facebook/wav2vec2-base-960h
    arch_cfg: wav2vec2.Wav2Vec2Config
    model: wav2vec2.Wav2Vec2Model
    pretrained: bool  # False => seeded random init
    layers_to_use: tuple = (-4, -3, -2, -1)
    # HF processor do_normalize: per-segment zero-mean/unit-var input
    input_normalize: bool = False

    @property
    def feature_dim(self) -> int:
        return self.arch_cfg.feature_dim

    @torch.inference_mode()
    def segment_features(self, segments: torch.Tensor) -> torch.Tensor:
        """``segments [..., L]`` → per-frame features ``[..., T, D]`` (f32).
        Leading dims flatten through one encoder call and are restored."""
        lead = segments.shape[:-1]
        flat = segments.reshape(-1, segments.shape[-1]).float()
        if self.input_normalize:
            # HF zero_mean_unit_var_norm (population variance, eps 1e-7)
            mean = flat.mean(-1, keepdim=True)
            var = (flat - mean).square().mean(-1, keepdim=True)
            flat = (flat - mean) / torch.sqrt(var + 1e-7)
        feats = wav2vec2.extract_features(self.model, flat,
                                          self.layers_to_use)
        return feats.reshape(lead + feats.shape[1:])


_PRESETS = {"wav2vec2-base": {}, "wav2vec2-base-960h": {},
            "wav2vec2-large-960h": dict(hidden_size=1024,
                                        num_hidden_layers=24,
                                        num_attention_heads=16,
                                        intermediate_size=4096),
            "hubert-base-ls960": {}}
_HF_FIELDS = ("hidden_size", "num_hidden_layers", "num_attention_heads",
              "intermediate_size", "conv_dim", "conv_kernel", "conv_stride",
              "conv_bias", "feat_extract_norm", "num_conv_pos_embeddings",
              "num_conv_pos_embedding_groups", "layer_norm_eps",
              "do_stable_layer_norm")


def _find_local_checkpoint(model_name: str, weights_dir: Optional[str]):
    candidates = []
    flat = model_name.replace("/", "--")
    if weights_dir:
        for fn in ("model.safetensors", "pytorch_model.bin"):
            candidates.append(os.path.join(weights_dir, flat, fn))
            candidates.append(
                os.path.join(weights_dir, model_name.split("/")[-1], fn))
    hf_home = os.environ.get(
        "HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    for fn in ("model.safetensors", "pytorch_model.bin"):
        candidates += glob.glob(os.path.join(
            hf_home, "hub", f"models--{flat}", "snapshots", "*", fn))
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def resolve_arch_config(model_name: str, ckpt_path: Optional[str] = None
                        ) -> wav2vec2.Wav2Vec2Config:
    """The checkpoint's own config.json when present, else a preset on the
    id's basename, else the base architecture with a warning."""
    if ckpt_path:
        cfg_json = os.path.join(os.path.dirname(ckpt_path), "config.json")
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                hf = json.load(f)
            kw = {k: (tuple(hf[k]) if isinstance(hf[k], list) else hf[k])
                  for k in _HF_FIELDS if k in hf}
            return wav2vec2.Wav2Vec2Config(**kw)
    preset = _PRESETS.get(model_name.split("/")[-1].lower())
    if preset is not None:
        return wav2vec2.Wav2Vec2Config(**preset)
    logger.warning("No architecture preset or config.json for %r — "
                   "assuming the base architecture.", model_name)
    return wav2vec2.Wav2Vec2Config()


def build_encoder(config, *, weights_dir: Optional[str] = None,
                  seed: int = 0, device="cuda") -> FrozenEncoder:
    """Factory on ``config.feature_extractor_type`` (reference
    pipeline.py:54-65), placed on ``device``."""
    dev = resolve_device(device)
    kind = config.feature_extractor_type
    if kind in ("wavlm", "whisper"):
        raise NotImplementedError(f"{kind} encoder: not yet ported")
    if kind not in ("wav2vec2", "hubert"):
        raise ValueError(f"Unknown feature extractor type: {kind!r}")
    if config.use_mixed_precision:
        raise NotImplementedError("mixed-precision encoder: not yet ported")
    model_name = (config.wav2vec2_model_name if kind == "wav2vec2"
                  else config.hubert_model_name)
    if weights_dir is None:
        weights_dir = os.path.join(config.data_root, "weights")
    ckpt = _find_local_checkpoint(model_name, weights_dir)
    arch_cfg = resolve_arch_config(model_name, ckpt)
    if ckpt is not None:
        logger.info("Loading %s weights from %s", kind, ckpt)
        model = hf_convert.convert_wav2vec2(
            hf_convert.load_state_dict(ckpt), arch_cfg)
    else:
        logger.warning(
            "No local checkpoint for %s (%s) under %s — using RANDOM "
            "encoder weights (seed %d).", kind, model_name, weights_dir, seed)
        model = wav2vec2.init_params(wav2vec2.Wav2Vec2Model(arch_cfg),
                                     torch.Generator().manual_seed(seed))
    normalize = config.input_normalize
    if normalize is None:
        normalize = False
        if ckpt is not None:
            pp_json = os.path.join(os.path.dirname(ckpt),
                                   "preprocessor_config.json")
            if os.path.exists(pp_json):
                with open(pp_json) as f:
                    normalize = bool(json.load(f).get("do_normalize", False))
    return FrozenEncoder(
        name=kind, model_name=model_name, arch_cfg=arch_cfg,
        model=model.to(dev).eval(), pretrained=ckpt is not None,
        layers_to_use=tuple(config.wav2vec2_layers_to_use),
        input_normalize=bool(normalize))
