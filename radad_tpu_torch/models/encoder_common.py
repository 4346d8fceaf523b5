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

Every block computes in its input's dtype: f32, or bf16 with
``use_mixed_precision`` (parameters stay f32 and are cast where they are
used). In bf16 each function rounds where its JAX counterpart's ops round
on the CPU, where XLA rounds every bf16 op's result: a linear or conv
product comes back in bf16 and its bias is added in bf16, GELU is the tanh
form written op by op with bf16 constants, the attention scale is rounded
to bf16, and the per-channel norm takes the JAX package's shifted moments.
A GELU and the bias add before it (``gelu_bias``: ``linear_gelu``,
``conv1d_gelu``) run on bf16 CUDA tensors as one kernel with the same bits
(``radad_tpu_torch/ops/bias_gelu.py``); a layer-normed front end's bias
add, LayerNorm over the channels and GELU (``conv1d_ln_gelu``) as one
kernel that sums its f32 statistics in another order
(``radad_tpu_torch/ops/channel_ln_gelu.py``). The f32 path keeps its own
arithmetic (fused bias adds, exact GELU, ``F.group_norm``).

Tensor parallelism (``parallel/tp.py``): with ``tp = (mesh, axis)`` the
layer's parameters are the rank's shard (q, k, v and the FFN's first
linear split by output rows, the output projection and the FFN's second
linear by input columns), ``self_attention`` runs the rank's H / S heads,
and each row-parallel product is summed over the axis group (one
all-reduce) before its bias is added once.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from radad_tpu_torch.ops.attention import (fused_mha, mha_reference,
                                           use_fused_attention)
from radad_tpu_torch.ops.bias_gelu import (bias_gelu, bias_gelu_plain,
                                           use_bias_gelu)
from radad_tpu_torch.ops.channel_ln_gelu import (channel_ln_gelu,
                                                 channel_ln_gelu_plain,
                                                 use_channel_ln_gelu)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                       bias.float(), eps)
    return out.to(x.dtype)


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a constant as the
    JAX package's ops see it in that dtype (a Python scalar there takes the
    array's dtype; here it would stay f32 inside the op)."""
    return float(torch.tensor(value, dtype=dtype))


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w.T (+ b); ``w`` is ``[out, in]``. Outside f32 the product is
    rounded to x's dtype before the bias is added in that dtype, as JAX's
    ``jnp.dot(..., preferred_element_type=x.dtype) + b`` (``F.linear``
    would add the bias before it rounds)."""
    if x.dtype == torch.float32:
        return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))
    out = F.linear(x, w.to(x.dtype))
    return out if b is None else out + b.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU: the exact erf in f32, as HF ACT2FN['gelu'] and the JAX
    package; in bf16 the JAX package's tanh form (``jax.nn.gelu(x,
    approximate=True)``), op by op in bf16 with its constants rounded to
    bf16, x³ as x · (x · x) (``ops/bias_gelu.bias_gelu_plain``)."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return bias_gelu_plain(x)


def gelu_bias(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
              channel_axis: bool = False) -> torch.Tensor:
    """``gelu(x + bias)``, the bias added in x's dtype along the last axis
    or, with ``channel_axis``, along axis 1 of a ``[B, C, T]`` conv output:
    where ``use_bias_gelu`` takes x (bf16 on CUDA, contiguous, no gradient
    to carry) the add and the GELU in one kernel with the same bits
    (``ops/bias_gelu.py``), elsewhere the add and then ``gelu``."""
    if bias is not None:
        bias = bias.to(x.dtype)
    if use_bias_gelu(x, bias):
        return bias_gelu(x, bias, channel_axis)
    if bias is not None:
        x = x + (bias[:, None] if channel_axis else bias)
    return gelu(x)


def linear_gelu(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """``gelu(linear(x, w, b))``; outside f32 the bias add goes with the
    GELU (``gelu_bias``)."""
    if x.dtype == torch.float32:
        return gelu(linear(x, w, b))
    return gelu_bias(linear(x, w), b)


def _row_parallel(partial: torch.Tensor, bias: torch.Tensor,
                  tp: tuple) -> torch.Tensor:
    """A row-parallel product's partial sum summed over the tensor-parallel
    group, then its bias."""
    mesh, axis = tp
    return mesh.all_reduce(partial, axis) + bias.to(partial.dtype)


def self_attention(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                   num_heads: int, *, bias_factors: Optional[tuple] = None,
                   tp: Optional[tuple] = None) -> torch.Tensor:
    """HF eager self-attention (modeling_wav2vec2.py): q scaled by
    head_dim**-0.5; logits optionally add ``bias_factors = (gate [B, T, H],
    pos_bias [H, T, T])``, WavLM's gated relative position bias in factored
    form. ``p``: qw, qb, kw, kb, vw, vb, ow, ob; "kb" may be absent
    (Whisper's k_proj has no bias). ``tp``: this rank's heads only
    (module docstring)."""
    _, t, d = x.shape
    # the scale in x's dtype (JAX: jnp.asarray(scaling, x.dtype)); in bf16
    # 80^-0.5 rounds to 0.11181640625
    scaling = rounded((d // num_heads) ** -0.5, x.dtype)
    q = linear(x, p["qw"], p["qb"]) * scaling
    k = linear(x, p["kw"], p.get("kb"))
    v = linear(x, p["vw"], p["vb"])
    gate, pos = bias_factors if bias_factors is not None else (None, None)
    heads = num_heads
    if tp is not None:
        mesh, axis = tp
        heads = num_heads // mesh.shape[axis]
        h0 = mesh.coord(axis) * heads
        if gate is not None:
            gate, pos = gate[..., h0:h0 + heads], pos[h0:h0 + heads]
    if use_fused_attention(t, d, x.device):
        ctx = fused_mha(q, k, v, heads,
                        gate=None if gate is None else gate.contiguous(),
                        pos_bias=None if pos is None else pos.contiguous())
    else:
        ctx = mha_reference(q, k, v, heads, gate=gate, pos_bias=pos)
    if tp is None:
        return linear(ctx, p["ow"], p["ob"])
    return _row_parallel(linear(ctx, p["ow"]), p["ob"], tp)


def feed_forward(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                 tp: Optional[tuple] = None) -> torch.Tensor:
    """Linear → GELU → Linear (HF Wav2Vec2FeedForward, Whisper's fc1 and
    fc2); with ``tp`` the rank's columns of the hidden layer."""
    h = linear_gelu(x, p["w1"], p["b1"])
    if tp is None:
        return linear(h, p["w2"], p["b2"])
    return _row_parallel(linear(h, p["w2"]), p["b2"], tp)


def post_ln_layer(x: torch.Tensor, p, num_heads: int, eps: float, *,
                  bias_factors: Optional[tuple] = None,
                  tp: Optional[tuple] = None) -> torch.Tensor:
    """Post-LN encoder layer (HF Wav2Vec2EncoderLayer, WavLM base):
    x = LN(x + attn(x)); x = LN2(x + ffn(x))."""
    h = x + self_attention(x, p["attn"], num_heads,
                           bias_factors=bias_factors, tp=tp)
    h = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"], eps)
    h = h + feed_forward(h, p["ffn"], tp)
    return layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"], eps)


def pre_ln_layer(x: torch.Tensor, p, num_heads: int, eps: float, *,
                 bias_factors: Optional[tuple] = None,
                 tp: Optional[tuple] = None) -> torch.Tensor:
    """Pre-LN encoder layer (HF WhisperEncoderLayer, and
    Wav2Vec2EncoderLayerStableLayerNorm of the ``do_stable_layer_norm``
    large variants): x += attn(LN(x)); x += ffn(LN2(x))."""
    h = x + self_attention(
        layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"], eps), p["attn"],
        num_heads, bias_factors=bias_factors, tp=tp)
    return h + feed_forward(
        layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"], eps), p["ffn"],
        tp)


def conv1d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor], stride: int, padding: int,
           groups: int = 1) -> torch.Tensor:
    """1-D convolution: ``x [B, C_in, T]``, ``kernel [C_out, C_in/g, K]``.
    Outside f32 the bias is added after the product is rounded, as in
    ``linear``."""
    if x.dtype == torch.float32:
        return F.conv1d(x, kernel.to(x.dtype),
                        None if bias is None else bias.to(x.dtype),
                        stride=stride, padding=padding, groups=groups)
    kernel = kernel.to(x.dtype)
    if x.device.type == "cpu":
        # oneDNN's bf16 grouped conv1d returned wrong sums (torch 2.13 CPU,
        # the 16-group positional conv); the f32 sum of the same bf16
        # operands, rounded once, is the product every backend means
        out = F.conv1d(x.float(), kernel.float(), stride=stride,
                       padding=padding, groups=groups).to(x.dtype)
    else:
        out = F.conv1d(x, kernel, stride=stride, padding=padding,
                       groups=groups)
    return out if bias is None else out + bias.to(x.dtype)[:, None]


def conv1d_gelu(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int, padding: int,
                groups: int = 1) -> torch.Tensor:
    """``gelu(conv1d(...))``; outside f32 the bias add goes with the GELU,
    as in ``linear_gelu``."""
    if x.dtype == torch.float32:
        return gelu(conv1d(x, kernel, bias, stride, padding, groups))
    return gelu_bias(conv1d(x, kernel, None, stride, padding, groups), bias,
                     channel_axis=True)


def conv1d_channels_last(x: torch.Tensor, kernel: torch.Tensor,
                         stride: int) -> torch.Tensor:
    """conv1d of ``x [B, C_in, T]`` without bias or padding, kernel cast
    to x's dtype: ``[B, C_out, T']`` with the channels fastest. A 2-D conv
    of ``[B, C_in, 1, T]`` in channels_last (cuDNN's NHWC kernels: the
    front end's row-major bf16 convs took over twice as long on an H100);
    with one input channel, where cuDNN writes row-major whatever the
    format, the product of the ``[B, T', K]`` windows and the
    ``[K, C_out]`` kernel."""
    kernel = kernel.to(x.dtype)
    if x.shape[1] == 1:
        windows = x[:, 0].unfold(-1, kernel.shape[-1], stride)
        return (windows @ kernel[:, 0].t()).transpose(1, 2)
    x4 = x.unsqueeze(2).contiguous(memory_format=torch.channels_last)
    k4 = kernel.unsqueeze(2).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x4, k4, stride=(1, stride)).squeeze(2)


def conv1d_ln_gelu(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor], stride: int,
                   scale: torch.Tensor, shift: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """``gelu(LayerNorm over the channels(conv1d(x, kernel, bias, stride,
    0)))`` on ``[B, C, T]``, a layer-normed front end's conv layer (HF
    Wav2Vec2LayerNormConvLayer). In f32 the bias goes inside the product;
    outside f32 it is added to the rounded product with the norm. On the
    card in bf16 the product is ``conv1d_channels_last``'s, so that each
    layer reads the last one's output as it lies, and the bias add, norm
    and GELU are one kernel where ``use_channel_ln_gelu`` takes the
    product (``ops/channel_ln_gelu.py``); elsewhere op by op
    (``channel_ln_gelu_plain``)."""
    if x.dtype == torch.float32:
        return channel_ln_gelu_plain(conv1d(x, kernel, bias, stride, 0),
                                     None, scale, shift, eps)
    out = (conv1d_channels_last(x, kernel, stride) if x.is_cuda
           else conv1d(x, kernel, None, stride, 0))
    if bias is not None:
        bias = bias.to(x.dtype)
    if use_channel_ln_gelu(out, bias, scale, shift):
        return channel_ln_gelu(out, bias, scale.float(), shift.float(), eps)
    return channel_ln_gelu_plain(out, bias, scale, shift, eps)


def instance_norm_channels(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, eps: float = 1e-5
                           ) -> torch.Tensor:
    """GroupNorm with one group per channel (per-channel norm over time),
    the first conv layer of Wav2Vec2's feature encoder
    (HF Wav2Vec2GroupNormConvLayer). ``x [B, C, T]``; moments in f32.

    In f32, ``F.group_norm``. Outside f32, the JAX package's form: moments
    shifted by s, the mean of 8 spread frames rounded to x's dtype, taken
    in f32 from ``x - s`` in x's dtype; then ``x * a + b`` with the affine
    ``a = rsqrt(var + eps) * scale`` and ``b = bias - mean * a`` rounded to
    x's dtype."""
    if x.dtype == torch.float32:
        return F.group_norm(x, x.shape[1], scale.float(), bias.float(), eps)
    t = x.shape[-1]
    probe = x[:, :, ::max(1, t // 8)][:, :, :8].float()
    s = probe.mean(-1, keepdim=True).to(x.dtype)
    xs = (x - s).float()
    m1s = xs.mean(-1, keepdim=True)
    m2s = xs.square().sum(-1, keepdim=True) / t
    var = (m2s - m1s.square()).clamp_min(0.0)
    m1 = m1s + s.float()
    inv = torch.rsqrt(var + eps)
    scale, bias = scale.float()[:, None], bias.float()[:, None]
    a = (inv * scale).to(x.dtype)
    b = (bias - m1 * inv * scale).to(x.dtype)
    return x * a + b


def conv_output_length(length: int, kernel: int, stride: int,
                       padding: int = 0) -> int:
    return (length + 2 * padding - kernel) // stride + 1
