"""WavLM encoder as a frozen PyTorch module.

Counterpart: ``radad_tpu/models/wavlm.py`` (the architecture of HF
``WavLMModel``, reference feature_extractor.py:117-170). The wav2vec2
skeleton (conv frontend, feature projection, positional conv, post-LN
layers, or pre-LN with ``do_stable_layer_norm``) plus WavLM's gated
relative position bias: a T5-style bucketed position embedding
``rel_attn_embed [num_buckets, H]`` gives ``pos_bias [H, T, T]`` once per
forward, and every layer gates it from its own attention input:

  proj     = Linear(head_dim → 8)(x per head) viewed [..., 2, 4], summed
  a, b     = sigmoid(proj)
  gate     = a * (b * gru_rel_pos_const - 1) + 2          → [B, T, H]
  bias     = gate[b, t, h] * pos_bias[h, t, s]            → the logits

The factored ``(gate, pos_bias)`` pair goes to the attention, where the
fused kernel forms the bias in registers (``ops/attention.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from radad_tpu_torch.models import encoder_common as C
from radad_tpu_torch.models import wav2vec2 as W


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """Defaults = microsoft/wavlm-base."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    num_buckets: int = 320
    max_bucket_distance: int = 800
    do_stable_layer_norm: bool = False  # True for wavlm-large (pre-LN)

    @property
    def feature_dim(self) -> int:
        return self.hidden_size

    def frames_for_samples(self, n: int) -> int:
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = C.conv_output_length(n, k, s)
        return n


def relative_position_buckets(seq_len: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """T5-style bidirectional bucket matrix ``[T, T]`` (host side), the
    same numbers as the JAX package's."""
    half = num_buckets // 2
    pos = np.arange(seq_len)
    rel = pos[None, :] - pos[:, None]  # memory - context
    buckets = (rel > 0).astype(np.int64) * half
    rel_abs = np.abs(rel)
    max_exact = half // 2
    is_small = rel_abs < max_exact
    # log-spaced buckets for large distances
    with np.errstate(divide="ignore"):
        large = np.log(np.maximum(rel_abs, 1) / max_exact) / math.log(
            max_distance / max_exact) * (half - max_exact)
    large = (max_exact + large).astype(np.int64)
    large = np.minimum(large, half - 1)
    buckets += np.where(is_small, rel_abs, large)
    return buckets  # [T, T] in [0, num_buckets)


class WavLMModel(W.Wav2Vec2Model):
    """Frozen parameters of one WavLM encoder: the wav2vec2 skeleton, a
    ``gate`` dict per layer (``w [8, head_dim]``, ``b [8]``,
    ``const [H]``) and ``rel_attn_embed [num_buckets, H]``."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__(cfg)
        h = cfg.num_attention_heads
        hd = cfg.hidden_size // h
        for layer in self.layers:
            layer["gate"] = nn.ParameterDict({
                "w": W._param(8, hd), "b": W._param(8),
                "const": nn.Parameter(torch.ones(h), requires_grad=False)})
        self.rel_attn_embed = W._param(cfg.num_buckets, h)


def gated_bias_factors(x: torch.Tensor, gate_p, num_heads: int
                       ) -> torch.Tensor:
    """Per-layer gate ``[B, T, H]`` for the shared ``[H, T, T]`` position
    bias, from that layer's attention input ``x [B, T, D]``, in x's dtype
    (gru_rel_pos_const cast to it, as JAX's ``_gated_bias_factors``)."""
    b, t, d = x.shape
    proj = C.linear(x.reshape(b, t, num_heads, d // num_heads), gate_p["w"],
                    gate_p["b"])  # [B, T, H, 8]
    gates = torch.sigmoid(proj.reshape(b, t, num_heads, 2, 4).sum(-1))
    const = gate_p["const"].reshape(1, 1, num_heads).to(x.dtype)
    return gates[..., 0] * (gates[..., 1] * const - 1.0) + 2.0


def position_bias(model: WavLMModel, t: int) -> torch.Tensor:
    """``pos_bias [H, T, T]`` for ``t`` frames."""
    cfg = model.cfg
    buckets = torch.as_tensor(relative_position_buckets(
        t, cfg.num_buckets, cfg.max_bucket_distance),
        device=model.rel_attn_embed.device)
    return model.rel_attn_embed[buckets].permute(2, 0, 1).contiguous()


def encode(model: WavLMModel, waveform: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> list:
    """``[B, T_samples]`` → hidden states in ``dtype``, a list of L+1
    ``[B, T_frames, D]`` (the ordering of ``wav2vec2.encode``). pos_bias
    and every layer's gate are in ``dtype`` too."""
    cfg = model.cfg
    eps, heads = cfg.layer_norm_eps, cfg.num_attention_heads
    x = W.embed_frames(model, waveform, dtype)
    enc_ln = model.encoder_ln
    if not cfg.do_stable_layer_norm:
        x = C.layer_norm(x, enc_ln["scale"], enc_ln["bias"], eps)
    pos = position_bias(model, x.shape[1]).to(x.dtype)
    hidden = [x]
    tp = getattr(model, "tp", None)  # parallel/tp.py's shard
    for layer in model.layers:
        if cfg.do_stable_layer_norm:
            # pre-LN (HF WavLMEncoderLayerStableLayerNorm): the gate reads
            # the same LN'd tensor the attention sees
            ln_x = C.layer_norm(x, layer["ln1"]["scale"],
                                layer["ln1"]["bias"], eps)
            gate = gated_bias_factors(ln_x, layer["gate"], heads)
            x = x + C.self_attention(ln_x, layer["attn"], heads,
                                     bias_factors=(gate, pos), tp=tp)
            x = x + C.feed_forward(C.layer_norm(
                x, layer["ln2"]["scale"], layer["ln2"]["bias"], eps),
                layer["ffn"], tp)
        else:
            gate = gated_bias_factors(x, layer["gate"], heads)
            x = C.post_ln_layer(x, layer, heads, eps,
                                bias_factors=(gate, pos), tp=tp)
        hidden.append(x)
    if cfg.do_stable_layer_norm:
        hidden[-1] = C.layer_norm(x, enc_ln["scale"], enc_ln["bias"], eps)
    return hidden


def extract_features(model: WavLMModel, waveform: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The last hidden state ``[B, T_frames, D]`` as f32, computed in
    ``dtype``, as the reference uses WavLM (feature_extractor.py:146-170)."""
    return encode(model, waveform, dtype)[-1].float()


@torch.no_grad()
def init_params(model: WavLMModel, generator: torch.Generator
                ) -> WavLMModel:
    """Seeded random init: the wav2vec2 skeleton's scales, gate linears
    uniform ±1/sqrt(head_dim), gate constants 1, position embedding
    normal × 0.02 (the JAX package's scales; its numbers differ)."""
    W.init_params(model, generator)
    hd = model.cfg.hidden_size // model.cfg.num_attention_heads
    bound = 1.0 / hd ** 0.5
    for layer in model.layers:
        for key in ("w", "b"):
            p = layer["gate"][key]
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                  generator=generator))
    model.rel_attn_embed.copy_(0.02 * torch.randn(
        model.rel_attn_embed.shape, generator=generator))
    return model
