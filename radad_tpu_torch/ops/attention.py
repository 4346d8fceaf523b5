"""Multi-head self-attention on the ``[B, T, D]`` projection layout.

Counterpart: ``radad_tpu/ops/attention.py`` (Pallas ``fused_mha``,
``mha_reference``, ``use_fused_attention``). The kernel is
``radad_tpu_torch/csrc/fused_mha.cu``: one kernel, templated on the bias,
for both Pallas bodies (``_mha_kernel`` and ``_mha_bias_kernel``).

``mha_reference`` is the default path, as in the JAX package. The fused
kernel is opt-in with ``RADAD_FUSED_ATTENTION=1`` (``use_fused_attention``).
``fused_mha`` launches the kernel for CUDA tensors and runs its plain
version, ``mha_reference``, only for CPU tensors. The kernel takes f32; a bf16 input
on CUDA raises (bf16 attention comes with the mixed-precision slice).

Numerics: the kernel computes both products, q·kᵀ and p·v, on the tensor
cores as 3xTF32: each f32 operand is split into a TF32 high part and a TF32
low part, and the products hi·lo, lo·hi and hi·hi are summed in f32. That
is f32-grade, and it is held to ``mha_reference`` within
1e-5 · (1 + |plain|): the f32 summation order, the online softmax over key
tiles and the ~2⁻²² relative split all sit well inside it, while one TF32
product alone (hi·hi) misses it by 20–100×
(``tests/test_torch_attention_tf32.py`` emulates both on the CPU;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernel to it on
the card).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from radad_tpu_torch.ops import _native

_HEAD_DIMS = (16, 32, 64, 80, 128)  # head widths the kernel is built for


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int, *, gate: Optional[torch.Tensor] = None,
                  pos_bias: Optional[torch.Tensor] = None,
                  bias_term: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain matmul + softmax on ``[B, T, D]`` with heads as column slices;
    ``q`` pre-scaled, logits and softmax in f32. ``gate [B, T, H]`` ×
    ``pos_bias [H, T, T]`` is WavLM's gated position bias in factored form;
    ``bias_term [B, H, T, T]`` is the same bias materialized."""
    b, t, d = q.shape
    hd = d // num_heads

    def split(h):
        return h.reshape(b, t, num_heads, hd).transpose(1, 2)  # [B,H,T,hd]

    logits = torch.matmul(split(q).float(), split(k).float().transpose(-1, -2))
    if gate is not None:
        logits = logits + (gate.transpose(1, 2)[..., None].float()
                           * pos_bias[None].float())
    if bias_term is not None:
        logits = logits + bias_term.float()
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    ctx = torch.matmul(w, split(v))  # [B, H, T, hd]
    return ctx.transpose(1, 2).reshape(b, t, d)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int, *, gate: Optional[torch.Tensor] = None,
              pos_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q, k, v [B, T, D]`` (q pre-scaled by head_dim**-0.5) → context
    ``[B, T, D]``, softmax over keys in f32. With ``gate [B, T, H]`` and
    ``pos_bias [H, T, T]`` the bias ``gate[b, t, h] * pos_bias[h, t, s]`` is
    added to the logits inside the kernel."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"fused_mha: want q, k, v [B, T, D] of one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, d = q.shape
    if d % num_heads:
        raise ValueError(f"fused_mha: D={d} is not a multiple of "
                         f"{num_heads} heads")
    if (gate is None) != (pos_bias is None):
        raise ValueError("fused_mha: gate and pos_bias come together")
    if gate is not None and (tuple(gate.shape) != (b, t, num_heads)
                             or tuple(pos_bias.shape) != (num_heads, t, t)):
        raise ValueError(f"fused_mha: want gate [{b}, {t}, {num_heads}] and "
                         f"pos_bias [{num_heads}, {t}, {t}], got "
                         f"{tuple(gate.shape)}, {tuple(pos_bias.shape)}")
    tensors = [q, k, v] + ([] if gate is None else [gate, pos_bias])
    if all(x.device.type == "cpu" for x in tensors):
        return mha_reference(q, k, v, num_heads, gate=gate,
                             pos_bias=pos_bias)
    _native.require_cuda("fused_mha", *tensors)
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"fused_mha: the kernel takes f32 only, got "
                        f"{sorted({str(x.dtype) for x in tensors})}")
    if d // num_heads not in _HEAD_DIMS:
        raise ValueError(f"fused_mha: head width {d // num_heads} not in "
                         f"{_HEAD_DIMS}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("fused_mha: q, k, v must be 16-byte aligned")
    if b > 65_535:
        raise ValueError(f"fused_mha: B={b} exceeds the grid's 65,535")
    out = torch.empty_like(q)
    if b * t == 0:
        return out
    fn = _native.library("fused_mha").radad_fused_mha
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if gate is None else gate.data_ptr(),
            None if gate is None else pos_bias.data_ptr(), out.data_ptr(),
            b, t, d, num_heads, _native.stream_of(q))
    _native.check_launch("fused_mha", rc)
    fused_mha.launches += 1
    fused_mha.body_launches["bias" if gate is not None else "no_bias"] += 1
    return out


fused_mha.launches = 0  # kernel launches (never the CPU plain version)
fused_mha.body_launches = {"bias": 0, "no_bias": 0}  # the same, per body


def reset_launches() -> None:
    """Set ``fused_mha``'s counts to 0 (both bodies)."""
    fused_mha.launches = 0
    fused_mha.body_launches = {"bias": 0, "no_bias": 0}


def use_fused_attention(t: int, d: int, device) -> bool:
    """Fused path gate, read at call time. Default False: the JAX package
    measured its plain path faster on the TPU, and the port keeps that
    default. ``RADAD_FUSED_ATTENTION=1`` opts in for tensors on CUDA and
    ``t <= 2048`` (the JAX gate's bound). ``d`` is unused, as in JAX."""
    if os.environ.get("RADAD_FUSED_ATTENTION") != "1":
        return False
    return torch.device(device).type == "cuda" and t <= 2048
