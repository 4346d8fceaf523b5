"""Frozen-encoder factory: wav2vec2, HuBERT, WavLM and Whisper.

Counterpart: ``radad_tpu/models/encoder.py`` (``FrozenEncoder``,
``build_encoder``, ``resolve_arch_config``). Weights resolve from local
files only: ``<weights_dir>/<model-name-with-slashes-as-dashes>/
{model.safetensors, pytorch_model.bin}``, else the HF cache layout, else a
seeded random init at full width with a warning (the pipeline's mechanics,
retrieval and timing do not depend on the weights).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
from typing import Optional, Union

import torch

from radad_tpu_torch.models import hf_convert, wav2vec2, wavlm, whisper
from radad_tpu_torch.utils.device import compute_dtype, resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FrozenEncoder:
    """A frozen pretrained speech encoder: module + architecture."""

    name: str  # "wav2vec2" | "hubert" | "wavlm" | "whisper"
    model_name: str  # HF-style id, e.g. facebook/wav2vec2-base-960h
    arch_cfg: Union[wav2vec2.Wav2Vec2Config, wavlm.WavLMConfig,
                    whisper.WhisperConfig]
    # a WavLMModel for "wavlm", a WhisperEncoder for "whisper"
    model: Union[wav2vec2.Wav2Vec2Model, whisper.WhisperEncoder]
    pretrained: bool  # False => seeded random init
    layers_to_use: tuple = (-4, -3, -2, -1)
    # HF processor do_normalize: per-segment zero-mean/unit-var input
    # (never applied to Whisper, whose input is the log-mel)
    input_normalize: bool = False
    # the forward's dtype (bf16 with use_mixed_precision); parameters f32
    compute_dtype: torch.dtype = torch.float32
    # Whisper: each segment padded to this many seconds before the mel
    # transform (the reference's 30 s); None = the real frames only
    whisper_pad_seconds: Optional[float] = 30.0

    @property
    def feature_dim(self) -> int:
        return self.arch_cfg.feature_dim

    def frames_per_segment(self, segment_samples: int) -> int:
        """Frames ``segment_features`` gives a segment of this length (for
        Whisper, in this encoder's pad mode)."""
        if self.name == "whisper":
            return self.arch_cfg.frames_for_samples(
                segment_samples, self.whisper_pad_seconds)
        return self.arch_cfg.frames_for_samples(segment_samples)

    @torch.inference_mode()
    def segment_features(self, segments: torch.Tensor) -> torch.Tensor:
        """``segments [..., L]`` → per-frame features ``[..., T, D]`` (f32,
        computed in ``compute_dtype`` after the f32 input normalization).
        Leading dims flatten through one encoder call and are restored."""
        lead = segments.shape[:-1]
        flat = segments.reshape(-1, segments.shape[-1]).float()
        if self.input_normalize and self.name != "whisper":
            # HF zero_mean_unit_var_norm (population variance, eps 1e-7)
            mean = flat.mean(-1, keepdim=True)
            var = (flat - mean).square().mean(-1, keepdim=True)
            flat = (flat - mean) / torch.sqrt(var + 1e-7)
        if self.name in ("wav2vec2", "hubert"):
            feats = wav2vec2.extract_features(self.model, flat,
                                              self.layers_to_use,
                                              self.compute_dtype)
        elif self.name == "wavlm":
            feats = wavlm.extract_features(self.model, flat,
                                           self.compute_dtype)
        elif self.name == "whisper":
            feats = whisper.extract_features(self.model, flat,
                                             self.whisper_pad_seconds,
                                             self.compute_dtype)
        else:
            raise ValueError(f"unknown encoder: {self.name}")
        return feats.reshape(lead + feats.shape[1:])


# Architecture presets on the model id's basename (the JAX package's
# _PRESETS); a checkpoint's own config.json wins over them.
_LARGE_STABLE = dict(hidden_size=1024, num_hidden_layers=24,
                     num_attention_heads=16, intermediate_size=4096,
                     feat_extract_norm="layer", conv_bias=True,
                     do_stable_layer_norm=True)
_PRESETS = {
    "wav2vec2": {
        "wav2vec2-base": {}, "wav2vec2-base-960h": {},
        # original large: post-LN, group-norm frontend
        "wav2vec2-large-960h": dict(hidden_size=1024, num_hidden_layers=24,
                                    num_attention_heads=16,
                                    intermediate_size=4096),
        # lv60 / robust / xlsr family: pre-LN, per-layer-LN frontend
        "wav2vec2-large-960h-lv60": _LARGE_STABLE,
        "wav2vec2-large-960h-lv60-self": _LARGE_STABLE,
        "wav2vec2-large-robust": _LARGE_STABLE,
        "wav2vec2-large-xlsr-53": _LARGE_STABLE,
    },
    "wavlm": {
        "wavlm-base": {}, "wavlm-base-plus": {}, "wavlm-base-sv": {},
        "wavlm-base-plus-sv": {},
        "wavlm-large": _LARGE_STABLE,
    },
    "hubert": {
        "hubert-base-ls960": {},
        "hubert-large-ls960-ft": _LARGE_STABLE,
        "hubert-xlarge-ls960-ft": dict(_LARGE_STABLE, hidden_size=1280,
                                       num_hidden_layers=48,
                                       intermediate_size=5120),
    },
    "whisper": {
        "whisper-tiny": dict(d_model=384, num_hidden_layers=4,
                             num_attention_heads=6, ffn_dim=1536),
        "whisper-base": {},
        "whisper-small": dict(d_model=768, num_hidden_layers=12,
                              num_attention_heads=12, ffn_dim=3072),
        "whisper-medium": dict(d_model=1024, num_hidden_layers=24,
                               num_attention_heads=16, ffn_dim=4096),
        "whisper-large": dict(d_model=1280, num_hidden_layers=32,
                              num_attention_heads=20, ffn_dim=5120),
        "whisper-large-v2": dict(d_model=1280, num_hidden_layers=32,
                                 num_attention_heads=20, ffn_dim=5120),
        "whisper-large-v3": dict(d_model=1280, num_hidden_layers=32,
                                 num_attention_heads=20, ffn_dim=5120,
                                 num_mel_bins=128),
    },
}
_CONFIGS = {"wav2vec2": wav2vec2.Wav2Vec2Config,
            "hubert": wav2vec2.Wav2Vec2Config, "wavlm": wavlm.WavLMConfig,
            "whisper": whisper.WhisperConfig}
# HF config.json key → the architecture config's field, per kind
_HF_FIELDS = {k: k for k in (
    "hidden_size", "num_hidden_layers", "num_attention_heads",
    "intermediate_size", "conv_dim", "conv_kernel", "conv_stride",
    "conv_bias", "feat_extract_norm", "num_conv_pos_embeddings",
    "num_conv_pos_embedding_groups", "layer_norm_eps",
    "do_stable_layer_norm")}
_HF_FIELD_MAP = {
    "wav2vec2": _HF_FIELDS, "hubert": _HF_FIELDS,
    "wavlm": dict(_HF_FIELDS, num_buckets="num_buckets",
                  max_bucket_distance="max_bucket_distance"),
    "whisper": {"d_model": "d_model", "encoder_layers": "num_hidden_layers",
                "encoder_attention_heads": "num_attention_heads",
                "encoder_ffn_dim": "ffn_dim", "num_mel_bins": "num_mel_bins",
                "max_source_positions": "max_source_positions"},
}


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


def resolve_arch_config(model_name: str, ckpt_path: Optional[str] = None,
                        kind: str = "wav2vec2"):
    """Architecture config of encoder ``kind`` for ``model_name``: the
    checkpoint's own config.json when present, else a preset on the id's
    basename, else the base architecture with a warning."""
    cfg_cls = _CONFIGS[kind]
    if ckpt_path:
        cfg_json = os.path.join(os.path.dirname(ckpt_path), "config.json")
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                hf = json.load(f)
            kw = {field: (tuple(hf[k]) if isinstance(hf[k], list) else hf[k])
                  for k, field in _HF_FIELD_MAP[kind].items() if k in hf}
            return cfg_cls(**kw)
    preset = _PRESETS[kind].get(model_name.split("/")[-1].lower())
    if preset is not None:
        return cfg_cls(**preset)
    logger.warning("No architecture preset or config.json for %s %r — "
                   "assuming the base architecture.", kind, model_name)
    return cfg_cls()


def build_encoder(config, *, weights_dir: Optional[str] = None,
                  seed: int = 0, device="cuda") -> FrozenEncoder:
    """Factory on ``config.feature_extractor_type`` (reference
    pipeline.py:54-65), placed on ``device``; f32 parameters, the forward
    in ``compute_dtype(config)``."""
    dev = resolve_device(device)
    kind = config.feature_extractor_type
    if kind not in _CONFIGS:
        raise ValueError(f"Unknown feature extractor type: {kind!r}")
    model_name = {"wav2vec2": config.wav2vec2_model_name,
                  "hubert": config.hubert_model_name,
                  "wavlm": config.wavlm_model_name,
                  "whisper": config.whisper_model_name}[kind]
    if weights_dir is None:
        weights_dir = os.path.join(config.data_root, "weights")
    ckpt = _find_local_checkpoint(model_name, weights_dir)
    arch_cfg = resolve_arch_config(model_name, ckpt, kind)
    if ckpt is not None:
        logger.info("Loading %s weights from %s", kind, ckpt)
        convert = {"wavlm": hf_convert.convert_wavlm,
                   "whisper": hf_convert.convert_whisper_encoder}.get(
                       kind, hf_convert.convert_wav2vec2)
        model = convert(hf_convert.load_state_dict(ckpt), arch_cfg)
    else:
        logger.warning(
            "No local checkpoint for %s (%s) under %s — using RANDOM "
            "encoder weights (seed %d).", kind, model_name, weights_dir, seed)
        gen = torch.Generator().manual_seed(seed)
        if kind == "wavlm":
            model = wavlm.init_params(wavlm.WavLMModel(arch_cfg), gen)
        elif kind == "whisper":
            model = whisper.init_params(whisper.WhisperEncoder(arch_cfg), gen)
        else:
            model = wav2vec2.init_params(wav2vec2.Wav2Vec2Model(arch_cfg),
                                         gen)
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
        input_normalize=bool(normalize), compute_dtype=compute_dtype(config),
        whisper_pad_seconds=config.whisper_pad_seconds)
