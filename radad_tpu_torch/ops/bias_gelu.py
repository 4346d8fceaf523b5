"""Bias add and the tanh GELU in bf16, in one pass: the encoders' FFN
hidden state and conv outputs.

Counterpart: the JAX package's bf16 chain, a linear's or conv's product
plus its bias and then ``jax.nn.gelu(x, approximate=True)``
(``radad_tpu/models/encoder_common.py``), which XLA on the TPU fuses into
one loop. PyTorch runs the same chain as ten elementwise kernels, each
reading and writing the whole activation. The kernel is
``radad_tpu_torch/csrc/bias_gelu.cu``: one read of x and one write of the
result, rounded to bf16 after every step where the chain rounds, so its
output is bit for bit ``bias_gelu_plain``'s.

``models/encoder_common.gelu_bias`` takes the kernel where
``use_bias_gelu`` says so (bf16 on CUDA, contiguous, no gradient to carry)
and the chain everywhere else. ``bias_gelu.launches`` counts the kernel's
launches, ``bias_gelu_plain.calls`` the bf16 GELUs on CUDA tensors that
ran op by op; ``reset_counts`` sets both to 0.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from radad_tpu_torch.ops import _native

_INT31 = 2**31


def reset_counts() -> None:
    bias_gelu.launches = bias_gelu_plain.calls = 0


def bias_gelu_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    channel_axis: bool = False) -> torch.Tensor:
    """The op-by-op chain: ``x + bias`` in x's dtype (``bias`` along the
    last axis, or along axis 1 of a ``[B, C, T]`` conv output with
    ``channel_axis``), then the JAX package's tanh GELU op by op with its
    constants rounded to x's dtype, x³ as x · (x · x)."""
    if bias is not None:
        bias = bias.to(x.dtype)
        x = x + (bias.view(-1, *([1] * (x.dim() - 2))) if channel_axis
                 else bias)
    if x.is_cuda and x.dtype == torch.bfloat16:
        bias_gelu_plain.calls += 1
    c, a = (float(torch.tensor(v, dtype=x.dtype))
            for v in (math.sqrt(2 / math.pi), 0.044715))
    inner = x + a * (x * (x * x))
    return x * (0.5 * (1.0 + torch.tanh(c * inner)))


bias_gelu_plain.calls = 0  # bf16 calls on CUDA tensors


def use_bias_gelu(x: torch.Tensor, bias: Optional[torch.Tensor] = None
                  ) -> bool:
    """Whether ``bias_gelu`` can take ``x``: bf16 on CUDA, contiguous, and
    no gradient to carry (the kernel has no backward)."""
    grad = torch.is_grad_enabled() and (
        x.requires_grad or (bias is not None and bias.requires_grad))
    return (x.dtype == torch.bfloat16 and x.is_cuda and x.is_contiguous()
            and not grad)


def bias_gelu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
              channel_axis: bool = False) -> torch.Tensor:
    """The kernel: ``bias_gelu_plain(x, bias, channel_axis)`` in one pass,
    bit for bit. ``x`` bf16, contiguous, on CUDA; ``bias`` None or a bf16
    vector as long as x's last axis (or, with ``channel_axis``, as x's axis
    1) on the same device."""
    if bias is not None:
        axis = 1 if channel_axis else -1
        if x.dim() < (2 if channel_axis else 1) or bias.shape != (
                x.shape[axis],):
            raise ValueError(f"bias_gelu: bias {tuple(bias.shape)} does not "
                             f"fit axis {axis} of x {tuple(x.shape)}")
    for t in (x,) if bias is None else (x, bias):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"bias_gelu: want bf16 tensors, got {t.dtype}")
    _native.require_cuda("bias_gelu", *((x,) if bias is None else (x, bias)))
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    # element i takes bias[(i // inner) % outer]; the kernel indexes in 32
    # bits, so larger tensors go in pieces of whole periods of the bias
    if bias is None:
        inner, outer = 1, 1
    elif channel_axis:
        inner, outer = math.prod(x.shape[2:]), x.shape[1]
    else:
        inner, outer = 1, x.shape[-1]
    period = inner * outer
    if period >= _INT31:
        raise ValueError(f"bias_gelu: a period of the bias of {period} "
                         f"elements needs 64-bit indices")
    piece = (_INT31 - 1) // period * period
    fn = _native.library("bias_gelu").radad_bias_gelu
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = _native.stream_of(x)
    bias_ptr = None if bias is None else bias.data_ptr()
    for start in range(0, n, piece):
        size = min(piece, n - start)
        rc = fn(x.data_ptr() + 2 * start, bias_ptr,
                out.data_ptr() + 2 * start, size, inner, outer, stream)
        _native.check_launch("bias_gelu", rc)
        bias_gelu.launches += 1
    return out


bias_gelu.launches = 0  # kernel launches (never the plain chain)
