"""Bias add, LayerNorm over the channels and the tanh GELU of a bf16 conv
output in one pass: the layer-normed conv front end of the large waveform
encoders (WavLM-Large, wav2vec2-large-lv60 / xlsr, HuBERT-large / xlarge).

Counterpart: the JAX package's chain in ``radad_tpu/models/wav2vec2.py``
(``feat_extract_norm == "layer"``): the conv's product plus its bias in
bf16, ``layer_norm`` over the channels in f32, rounded back to bf16, then
``jax.nn.gelu(x, approximate=True)`` op by op, which XLA fuses into one
loop. PyTorch runs it as ``channel_ln_gelu_plain``: a bias add, a transpose
and cast to f32, ``F.layer_norm``, the cast back, the GELU (``bias_gelu``
on the card) and the transpose back. The kernel is
``radad_tpu_torch/csrc/channel_ln_gelu.cu``: one read of x and one write
of the result, rounded where the chain rounds; only the order of its f32
sums differs (``compare_with_chain`` states what that allows).

``models/encoder_common.conv1d_ln_gelu`` takes the kernel where
``use_channel_ln_gelu`` says so (bf16 on CUDA, channels-last as the card's
front-end convs write it, a multiple of 8 channels up to 512 at a 16-byte
aligned address, no gradient to carry) and
the chain everywhere else. ``channel_ln_gelu.launches`` counts the
kernel's launches, ``channel_ln_gelu_plain.calls`` the bf16 chains on CUDA
tensors that ran op by op; ``reset_counts`` sets both to 0.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from radad_tpu_torch.ops import _native
from radad_tpu_torch.ops.bias_gelu import (bias_gelu, bias_gelu_plain,
                                           use_bias_gelu)

MAX_CHANNELS = 512  # the kernel holds a (b, t) row in a warp's registers
CHANNEL_STEP = 8  # ... as 16-byte vectors: C a multiple of 8, x aligned


def reset_counts() -> None:
    channel_ln_gelu.launches = channel_ln_gelu_plain.calls = 0


def _layer_norm_f32(x: torch.Tensor, bias: Optional[torch.Tensor],
                    scale: torch.Tensor, shift: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """The chain's f32 LayerNorm output of ``x [B, C, T]``, as
    ``[B, T, C]``, before its rounding: ``x + bias`` along the channels in
    x's dtype, LayerNorm over the channels in f32 on the transpose."""
    if bias is not None:
        x = x + bias.to(x.dtype)[:, None]
    return F.layer_norm(x.transpose(1, 2).float(), (x.shape[1],),
                        scale.float(), shift.float(), eps)


def channel_ln_gelu_plain(x: torch.Tensor, bias: Optional[torch.Tensor],
                          scale: torch.Tensor, shift: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """The chain on ``x [B, C, T]``: ``x + bias`` along the channels in
    x's dtype, LayerNorm over the channels in f32 on the transposed
    ``[B, T, C]`` (``scale``, ``shift`` in f32), rounded to x's dtype, the
    GELU (exact erf in f32; in bf16 the tanh form, through ``bias_gelu``
    where ``use_bias_gelu`` takes it), transposed back to ``[B, C, T]``."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        channel_ln_gelu_plain.calls += 1
    y = _layer_norm_f32(x, bias, scale, shift, eps).to(x.dtype)
    if y.dtype == torch.float32:
        y = F.gelu(y)
    else:
        y = bias_gelu(y) if use_bias_gelu(y) else bias_gelu_plain(y)
    return y.transpose(1, 2)


def _bf16_neighbours(y: torch.Tensor):
    """The two bf16 values next to each of ``y``'s (one step of the
    magnitude's bits either way; at +-0 the smallest denormals of both
    signs)."""
    bits = y.view(torch.int16).to(torch.int32) & 0xFFFF
    sign, mag = bits & 0x8000, bits & 0x7FFF
    up = sign | (mag + 1)
    down = torch.where(mag == 0, (sign ^ 0x8000) | 1, sign | (mag - 1))
    return [torch.where(v >= 0x8000, v - 0x10000, v).to(torch.int16).view(
        torch.bfloat16) for v in (up, down)]


def compare_with_chain(got: torch.Tensor, x: torch.Tensor,
                       bias: Optional[torch.Tensor], scale: torch.Tensor,
                       shift: torch.Tensor, eps: float = 1e-5) -> dict:
    """The kernel's contract on the bf16 ``got [B, C, T]``: a change of the
    order of the f32 sums and not of precision. An element holds where it
    is the GELU of the chain's bf16 LayerNorm output y or of one of y's two
    bf16 neighbours (a rounding boundary between the two f32 results), or
    where the GELU halves exactly (|y| below ~2e-3, where 1 + tanh rounds
    to 1: the kernel's y is 2 got) and 2 got lies within half a bf16 step
    plus ``band`` of the chain's f32 output z, ``band`` = 2^-21 (|scale|
    rstd (max |v| + |v - mean|) + |shift|) with v, mean, rstd of the
    element's column: 4 f32 steps of the terms, where y near 0 is the
    difference of two larger terms (the kernel on an H100 reads at most
    about a tenth of it; the same arithmetic with bf16 statistics fails
    it). → {"off": elements that hold neither way, "off_one_step":
    elements off the first clause alone, "bits_apart": elements whose bits
    differ from the chain's, "band_ratio": the largest |2 got - z| / band
    of the second clause's elements, "max_abs_err": the largest |got -
    the chain's output|}. Counts nothing."""
    z = _layer_norm_f32(x, bias, scale, shift, eps).transpose(1, 2)
    y = z.to(torch.bfloat16)
    calls = bias_gelu_plain.calls
    want = got.view(torch.int16)
    chain = bias_gelu_plain(y)
    exact = chain.view(torch.int16) == want
    step = exact.clone()
    for n in _bf16_neighbours(y):
        step |= bias_gelu_plain(n).view(torch.int16) == want
    twice = 2 * got  # exact in bf16 short of its largest binade
    halves = bias_gelu_plain(twice).view(torch.int16) == want
    bias_gelu_plain.calls = calls
    v = (x if bias is None else x + bias.to(x.dtype)[:, None]).float()
    mean = v.mean(1, keepdim=True)
    rstd = torch.rsqrt((v - mean).square().mean(1, keepdim=True) + eps)
    band = 2.0 ** -21 * (scale.float().abs()[:, None] * rstd * (
        v.abs().amax(1, keepdim=True) + (v - mean).abs())
        + shift.float().abs()[:, None])
    t = twice.float()
    off_z = (t - z).abs()
    near = halves & (off_z <= band + t.abs() * 2.0 ** -8)
    ratio = (off_z / band)[near & ~step]
    return {"off": int((~(step | near)).sum()),
            "off_one_step": int((~step).sum()),
            "bits_apart": int((~exact).sum()),
            "band_ratio": float(ratio.max()) if ratio.numel() else 0.0,
            "max_abs_err": float((got.float() - chain.float()).abs().max())
            if got.numel() else 0.0}


def _channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` is a ``[B, C, T]`` laid out channels-last: contiguous
    as ``[B, T, C]``, each (b, t) a row of C."""
    return x.dim() == 3 and x.transpose(1, 2).is_contiguous()


def _vector_rows(x: torch.Tensor) -> bool:
    """Whether the kernel's 16-byte vectors fit ``x``'s rows: a multiple
    of 8 channels, 8 to 512, from a 16-byte aligned address."""
    c = x.shape[1]
    return (CHANNEL_STEP <= c <= MAX_CHANNELS and c % CHANNEL_STEP == 0
            and x.data_ptr() % 16 == 0)


def use_channel_ln_gelu(x: torch.Tensor, *params: Optional[torch.Tensor]
                        ) -> bool:
    """Whether ``channel_ln_gelu`` can take ``x [B, C, T]``: bf16 on CUDA,
    channels-last, ``_vector_rows`` (a multiple of 8 channels up to 512,
    16-byte aligned), and no gradient to carry through x or ``params``
    (bias, scale, shift; the kernel has no backward)."""
    grad = torch.is_grad_enabled() and any(
        p is not None and p.requires_grad for p in (x, *params))
    return (x.dtype == torch.bfloat16 and x.is_cuda and not grad
            and _channels_last(x) and _vector_rows(x))


def channel_ln_gelu(x: torch.Tensor, bias: Optional[torch.Tensor],
                    scale: torch.Tensor, shift: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """The kernel: ``channel_ln_gelu_plain(x, bias, scale, shift, eps)`` in
    one pass, channels-last like x. ``x`` bf16 ``[B, C, T]`` on CUDA,
    channels-last, C a multiple of 8 up to 512, at a 16-byte aligned
    address; ``bias`` None or C bf16 values;
    ``scale``, ``shift`` C f32 values; all on x's device."""
    if x.dtype != torch.bfloat16 or (bias is not None
                                     and bias.dtype != torch.bfloat16):
        raise TypeError(f"channel_ln_gelu: want bf16 x and bias, got "
                        f"{x.dtype}, {None if bias is None else bias.dtype}")
    for name, p in (("scale", scale), ("shift", shift)):
        if p.dtype != torch.float32:
            raise TypeError(f"channel_ln_gelu: want an f32 {name}, got "
                            f"{p.dtype}")
    if not _channels_last(x):
        raise ValueError(f"channel_ln_gelu: want a channels-last [B, C, T] "
                         f"tensor, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    c = x.shape[1]
    if not _vector_rows(x):
        raise ValueError(f"channel_ln_gelu: {c} channels at address "
                         f"{x.data_ptr():#x}, want a multiple of "
                         f"{CHANNEL_STEP} up to {MAX_CHANNELS}, 16-byte "
                         f"aligned")
    params = [p for p in (bias, scale, shift) if p is not None]
    for p in params:
        if p.shape != (c,):
            raise ValueError(f"channel_ln_gelu: a parameter of shape "
                             f"{tuple(p.shape)} for {c} channels")
    _native.require_cuda("channel_ln_gelu", *params)  # x's layout: above
    if x.device.type != "cuda" or x.device != scale.device:
        raise ValueError(f"channel_ln_gelu: x on {x.device}, its parameters "
                         f"on {scale.device}; want one CUDA device")
    out = torch.empty_like(x)  # the same strides: x is dense; aligned
    if x.numel() == 0:
        return out
    rc = _native.library("channel_ln_gelu").radad_channel_ln_gelu(
        x.data_ptr(), None if bias is None else bias.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
        x.shape[0] * x.shape[2], c, eps, _native.stream_of(x))
    _native.check_launch("channel_ln_gelu", rc)
    channel_ln_gelu.launches += 1
    return out


reset_counts()  # the kernel's launches (never the chain's), the chain's calls
