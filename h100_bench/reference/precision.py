"""How the reference rounds the operands of its products.

A run of the reference names one kind for each product:

- ``"exact"``: no rounding (float32 with TF32 off, or float64);
- ``"bf16"``: both operands and the result rounded to bfloat16, the sum
  in float32: a stage in the bfloat16 that a configuration states, the
  scale of its own rounding;
- ``"tf32"``: both operands rounded to TF32 (10 mantissa bits, nearest
  even), the sum in float32: what a tensor core does with TF32 on. The
  control of a stage that the configuration computes in float32;
- ``"fp8"``: both operands scaled by their own largest magnitude and
  rounded to float8 e4m3, the sum in float32, and the result rounded to
  float8 e4m3 the same way: every product computed in float8, as the
  bfloat16 stage it controls rounds each product's result to bfloat16.
  The control of a stage that the configuration computes in bfloat16.

The rounding is written out, so it is the same on the CPU and the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KINDS = ("exact", "bf16", "tf32", "fp8")
# the control of each precision a configuration states: one step below
CONTROL_OF = {"float32": "tf32", "bfloat16": "fp8"}
# each precision a configuration states, as the reference computes it
OWN_KIND = {"float32": "exact", "bfloat16": "bf16"}
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to 10 mantissa bits, ties to even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -8192).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 after a round trip through float8 e4m3 under one
    scale for the whole tensor (its largest magnitude maps to 448)."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def rounded(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "exact":
        return x
    if kind == "tf32":
        return round_tf32(x)
    if kind == "fp8":
        return round_fp8(x)
    if kind == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    raise ValueError(f"unknown precision kind {kind!r}")


class _RoundedLinear(torch.autograd.Function):
    """``x @ w.T`` with every operand of the forward and of both backward
    products rounded, as a tensor core in that precision takes them."""

    @staticmethod
    def forward(ctx, x, w, kind):
        xr, wr = rounded(x, kind), rounded(w, kind)
        ctx.save_for_backward(xr, wr)
        ctx.kind = kind
        return xr @ wr.t()

    @staticmethod
    def backward(ctx, grad):
        xr, wr = ctx.saved_tensors
        g = rounded(grad, ctx.kind)
        gx = g @ wr
        gw = (g.reshape(-1, g.shape[-1]).t()
              @ xr.reshape(-1, xr.shape[-1]))
        return gx, gw, None


def _result(x, kind: str):
    """A product's result: rounded in float8 and bfloat16, float32
    otherwise."""
    return rounded(x, kind) if kind in ("fp8", "bf16") else x


def linear(x, w, b=None, kind: str = "exact"):
    """``x @ w.T + b`` (``w`` is ``[out, in]``) in ``kind``."""
    if kind == "exact":
        return F.linear(x, w, b)
    out = _RoundedLinear.apply(x, w, kind)
    return _result(out if b is None else out + b, kind)


def matmul(a, b, kind: str = "exact"):
    """``a @ b`` in ``kind`` (no autograd through the rounding)."""
    return _result(torch.matmul(rounded(a, kind), rounded(b, kind)), kind)


def conv1d(x, w, b, stride: int, padding: int, groups: int = 1,
           kind: str = "exact"):
    """1-D convolution ``x [B, C_in, T]``, ``w [C_out, C_in/g, K]``."""
    return _result(F.conv1d(rounded(x, kind), rounded(w, kind), b,
                            stride=stride, padding=padding, groups=groups),
                   kind)
