"""Transformer and convolution blocks for the frozen speech encoders.

Counterpart: ``radad_tpu/models/encoder_common.py``. Plain functions on
tensors; parameters arrive as mappings (``nn.ParameterDict``) with the JAX
package's key names, in PyTorch's layouts: linear weights ``[out, in]``,
conv kernels ``[C_out, C_in/groups, K]``, activations ``[B, C, T]`` inside
the conv stack.

Attention routes through ``radad_tpu_torch/ops/attention.py``: plain
matmul plus softmax (``mha_reference``) by default, as in the JAX package,
and the fused CUDA kernel (``fused_mha``) with ``RADAD_FUSED_ATTENTION=1``
on CUDA tensors.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from radad_tpu_torch.ops.attention import (fused_mha, mha_reference,
                                           use_fused_attention)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                       bias.float(), eps)
    return out.to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w.T (+ b); ``w`` is ``[out, in]``."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the exact erf, as HF ACT2FN['gelu'] and the JAX package
    in f32 (its bf16 tanh form comes with the mixed-precision slice)."""
    return F.gelu(x)


def self_attention(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                   num_heads: int, *,
                   bias_factors: Optional[tuple] = None) -> torch.Tensor:
    """HF eager self-attention (modeling_wav2vec2.py): q scaled by
    head_dim**-0.5; logits optionally add ``bias_factors = (gate [B, T, H],
    pos_bias [H, T, T])``, WavLM's gated relative position bias in factored
    form. ``p``: qw, qb, kw, kb, vw, vb, ow, ob."""
    _, t, d = x.shape
    scaling = (d // num_heads) ** -0.5
    q = linear(x, p["qw"], p["qb"]) * scaling
    k = linear(x, p["kw"], p["kb"])
    v = linear(x, p["vw"], p["vb"])
    gate, pos = bias_factors if bias_factors is not None else (None, None)
    if use_fused_attention(t, d, x.device):
        ctx = fused_mha(q, k, v, num_heads,
                        gate=None if gate is None else gate.contiguous(),
                        pos_bias=None if pos is None else pos.contiguous())
    else:
        ctx = mha_reference(q, k, v, num_heads, gate=gate, pos_bias=pos)
    return linear(ctx, p["ow"], p["ob"])


def feed_forward(x: torch.Tensor, p: Mapping[str, torch.Tensor]
                 ) -> torch.Tensor:
    """Linear → GELU → Linear (HF Wav2Vec2FeedForward)."""
    return linear(gelu(linear(x, p["w1"], p["b1"])), p["w2"], p["b2"])


def post_ln_layer(x: torch.Tensor, p, num_heads: int, eps: float, *,
                  bias_factors: Optional[tuple] = None) -> torch.Tensor:
    """Post-LN encoder layer (HF Wav2Vec2EncoderLayer, WavLM base):
    x = LN(x + attn(x)); x = LN2(x + ffn(x))."""
    h = x + self_attention(x, p["attn"], num_heads,
                           bias_factors=bias_factors)
    h = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"], eps)
    h = h + feed_forward(h, p["ffn"])
    return layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"], eps)


def pre_ln_layer(x: torch.Tensor, p, num_heads: int, eps: float, *,
                 bias_factors: Optional[tuple] = None) -> torch.Tensor:
    """Pre-LN encoder layer (HF Wav2Vec2EncoderLayerStableLayerNorm, the
    ``do_stable_layer_norm`` large variants): x += attn(LN(x));
    x += ffn(LN2(x))."""
    h = x + self_attention(
        layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"], eps), p["attn"],
        num_heads, bias_factors=bias_factors)
    return h + feed_forward(
        layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"], eps), p["ffn"])


def conv1d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor], stride: int, padding: int,
           groups: int = 1) -> torch.Tensor:
    """1-D convolution: ``x [B, C_in, T]``, ``kernel [C_out, C_in/g, K]``."""
    return F.conv1d(x, kernel.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=padding, groups=groups)


def instance_norm_channels(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, eps: float = 1e-5
                           ) -> torch.Tensor:
    """GroupNorm with one group per channel (per-channel norm over time),
    the first conv layer of Wav2Vec2's feature encoder
    (HF Wav2Vec2GroupNormConvLayer). ``x [B, C, T]``; moments in f32."""
    out = F.group_norm(x.float(), x.shape[1], scale.float(), bias.float(),
                       eps)
    return out.to(x.dtype)


def conv_output_length(length: int, kernel: int, stride: int,
                       padding: int = 0) -> int:
    return (length + 2 * padding - kernel) // stride + 1
