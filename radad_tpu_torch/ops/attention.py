"""Multi-head self-attention on the ``[B, T, D]`` projection layout.

Counterpart: ``radad_tpu/ops/attention.py`` (Pallas ``fused_mha``,
``mha_reference``, ``use_fused_attention``). The kernel is
``radad_tpu_torch/csrc/fused_mha.cu``: one kernel, templated on the bias,
for both Pallas bodies (``_mha_kernel`` and ``_mha_bias_kernel``), in f32
and in bf16.

``mha_reference`` is the default path, as in the JAX package. The fused
kernel is opt-in with ``RADAD_FUSED_ATTENTION=1`` (``use_fused_attention``).
``fused_mha`` launches the kernel for CUDA tensors and runs its plain
version, ``fused_mha_plain``, only for CPU tensors. It takes q, k, v (and
gate, pos_bias) all f32 or all bf16; a mix raises.

The two plain functions differ in bf16 only, where they follow their JAX
counterparts: ``mha_reference`` forms the q·kᵀ logits in bf16 and then
moves them to f32 (the JAX package's XLA path); ``fused_mha_plain`` forms
them in f32 from the bf16 operands, as the Pallas bodies do. Both take the
softmax in f32, cast the normalized weights to v's dtype, accumulate p·v in
f32 and return q's dtype. In bf16 the two differ by up to ``rtol 0.05,
atol 0.12`` (tests/test_attention.py), from how bf16 logits round near
ties; in f32 they are the same function.

Numerics of the kernel: f32 inputs run both products on the tensor cores
as 3xTF32: each f32 operand is split into a TF32 high part and a TF32 low
part, and the products hi·lo, lo·hi and hi·hi are summed in f32. That is
f32-grade, and it is held to ``fused_mha_plain`` within
1e-5 · (1 + |plain|): the f32 summation order, the online softmax over key
tiles and the ~2⁻²² relative split all sit well inside it, while one TF32
product alone (hi·hi) misses it by 20–100×
(``tests/test_torch_attention_tf32.py`` emulates both on the CPU). bf16
inputs run one bf16 product each (exact in f32) and round the normalized
weights to bf16 where the Pallas body does, in one of two forms that the
wrapper picks by shape (``bf16_form``) and passes to the C entry: at
T <= 128 and head width <= 80 (every shipped encoder's 2 s window, T = 99)
the resident form holds a row's whole key range in shared memory and its
logits in registers, and takes the exact row max and sum in one pass
(e = exp(s − m) by ex2, p = e · (1/l); at head width 64 without bias on
``wgmma`` with TMA copies, P·V summed in one accumulator,
``tests/test_torch_attention_resident_wgmma.py``); above (Whisper's T = 1,500) and
at head width 128, the streamed form makes one pass over 64-key tiles with
an online softmax (on ``wgmma`` at head width 64, ``mma.sync`` at the
others): per tile the row max m, O and l rescaled by
exp(m_old − m), e = exp(s − m) rounded to bf16 as the weights of P·V,
accumulated in f32 across tiles, and one division by l at the end. So it
rounds unnormalized weights where the Pallas body rounds normalized ones,
an intended difference inside the tolerance. The output is rounded to
bf16, so kernel and plain version differ by about a bf16 rounding of the
output, held within ``BF16_TOL`` · (1 + |plain|)
(``tests/test_torch_attention_bf16.py`` emulates both forms, with controls
that fail). ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernel
to both tolerances on the card.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from radad_tpu_torch.ops import _native

_HEAD_DIMS = (16, 32, 64, 80, 128)  # head widths the kernel is built for
BF16_TOL = 1e-2  # bf16 kernel: |kernel - plain| <= BF16_TOL * (1 + |plain|)
_BODIES = ("bias", "no_bias", "bias_bf16", "no_bias_bf16")
# the bf16 bodies' two forms, by their code in radad_fused_mha_bf16
_FORMS = ("streamed", "resident")
_RESIDENT_MAX_T = 128  # the resident form holds every key of a row at once
_RESIDENT_HEAD_DIMS = (16, 32, 64, 80)  # HD 128 takes the streamed form


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _softmax_pv(logits, q, v, num_heads, gate, pos_bias, bias_term):
    """f32 ``logits [B, H, T, T]`` + the bias → softmax in f32 → weights in
    v's dtype → p·v → ``[B, T, D]`` in q's dtype."""
    if gate is not None:
        logits = logits + (gate.transpose(1, 2)[..., None].float()
                           * pos_bias[None].float())
    if bias_term is not None:
        logits = logits + bias_term.float()
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.matmul(w, _heads(v, num_heads)).to(q.dtype)  # [B, H, T, hd]
    b, t, d = q.shape
    return ctx.transpose(1, 2).reshape(b, t, d)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int, *, gate: Optional[torch.Tensor] = None,
                  pos_bias: Optional[torch.Tensor] = None,
                  bias_term: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain matmul + softmax on ``[B, T, D]`` with heads as column slices;
    ``q`` pre-scaled. The logits come in q's dtype (in bf16 rounded once,
    as the JAX package's bf16 path) and go to f32 for the bias and the
    softmax. ``gate [B, T, H]`` × ``pos_bias [H, T, T]`` is WavLM's gated
    position bias in factored form; ``bias_term [B, H, T, T]`` is the same
    bias materialized."""
    logits = torch.matmul(_heads(q, num_heads),
                          _heads(k, num_heads).transpose(-1, -2)).float()
    return _softmax_pv(logits, q, v, num_heads, gate, pos_bias, bias_term)


def fused_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, *, gate: Optional[torch.Tensor] = None,
                    pos_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's plain version, the Pallas bodies' semantics: f32 logits
    from the operands (bf16 products are exact in f32), the bias and the
    softmax in f32, the normalized weights in v's dtype, p·v accumulated in
    f32, the output in q's dtype. In f32 it is ``mha_reference``."""
    logits = torch.matmul(_heads(q, num_heads).float(),
                          _heads(k, num_heads).float().transpose(-1, -2))
    if q.dtype == torch.float32:
        return _softmax_pv(logits, q, v, num_heads, gate, pos_bias, None)
    if gate is not None:
        logits = logits + (gate.transpose(1, 2)[..., None].float()
                           * pos_bias[None].float())
    w = torch.softmax(logits, dim=-1).to(v.dtype).float()
    ctx = torch.matmul(w, _heads(v, num_heads).float()).to(q.dtype)
    b, t, d = q.shape
    return ctx.transpose(1, 2).reshape(b, t, d)


def bf16_form(t: int, head_dim: int) -> str:
    """The bf16 body's form for ``T`` and the head width: "resident" (every
    key of a row in registers, exact row max and sum) at T <= 128 and
    HD <= 80, else "streamed" (one pass over 64-key tiles, online
    softmax)."""
    if t <= _RESIDENT_MAX_T and head_dim in _RESIDENT_HEAD_DIMS:
        return "resident"
    return "streamed"


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int, *, gate: Optional[torch.Tensor] = None,
              pos_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q, k, v [B, T, D]`` (q pre-scaled by head_dim**-0.5) → context
    ``[B, T, D]`` in their dtype (f32 or bf16), softmax over keys in f32.
    With ``gate [B, T, H]`` and ``pos_bias [H, T, T]`` (the same dtype) the
    bias ``gate[b, t, h] * pos_bias[h, t, s]`` is added to the logits inside
    the kernel."""
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
    dtypes = {x.dtype for x in tensors}
    if len(dtypes) != 1 or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_mha: want all inputs f32 or all bf16, got "
                        f"{sorted(str(x) for x in dtypes)}")
    if all(x.device.type == "cpu" for x in tensors):
        return fused_mha_plain(q, k, v, num_heads, gate=gate,
                               pos_bias=pos_bias)
    _native.require_cuda("fused_mha", *tensors)
    if d // num_heads not in _HEAD_DIMS:
        raise ValueError(f"fused_mha: head width {d // num_heads} not in "
                         f"{_HEAD_DIMS}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("fused_mha: q, k, v must be 16-byte aligned")
    if pos_bias is not None and pos_bias.data_ptr() % 16:
        raise ValueError("fused_mha: pos_bias must be 16-byte aligned")
    if b > 65_535:
        raise ValueError(f"fused_mha: B={b} exceeds the grid's 65,535")
    out = torch.empty_like(q)
    if b * t == 0:
        return out
    bf16 = q.dtype == torch.bfloat16
    lib = _native.library("fused_mha")
    if bf16:  # the form goes to the C entry, which refuses one it cannot take
        form = bf16_form(t, d // num_heads)
        fn, extra = lib.radad_fused_mha_bf16, [_FORMS.index(form)]
    else:
        fn, extra = lib.radad_fused_mha, []
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if gate is None else gate.data_ptr(),
            None if gate is None else pos_bias.data_ptr(), out.data_ptr(),
            b, t, d, num_heads, *extra, _native.stream_of(q))
    _native.check_launch("fused_mha", rc)
    fused_mha.launches += 1
    body = "bias" if gate is not None else "no_bias"
    fused_mha.body_launches[body + ("_bf16" if bf16 else "")] += 1
    if bf16:
        fused_mha.form_launches[form] += 1
    return out


fused_mha.launches = 0  # kernel launches (never the CPU plain version)
fused_mha.body_launches = dict.fromkeys(_BODIES, 0)  # the same, per body
fused_mha.form_launches = dict.fromkeys(_FORMS, 0)  # bf16 launches, per form


def reset_launches() -> None:
    """Set ``fused_mha``'s counts to 0 (every body and form)."""
    fused_mha.launches = 0
    fused_mha.body_launches = dict.fromkeys(_BODIES, 0)
    fused_mha.form_launches = dict.fromkeys(_FORMS, 0)


def use_fused_attention(t: int, d: int, device) -> bool:
    """Fused path gate, read at call time. Default False: the JAX package
    measured its plain path faster on the TPU, and the port keeps that
    default. ``RADAD_FUSED_ATTENTION=1`` opts in for tensors on CUDA and
    ``t <= 2048`` (the JAX gate's bound). ``d`` is unused, as in JAX."""
    if os.environ.get("RADAD_FUSED_ATTENTION") != "1":
        return False
    return torch.device(device).type == "cuda" and t <= 2048
