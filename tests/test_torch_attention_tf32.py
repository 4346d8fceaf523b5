"""The arithmetic of ``radad_tpu_torch/csrc/fused_mha.cu`` on the CPU.

The kernel runs both attention products as 3xTF32 on the tensor cores: each
f32 operand is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and
for each k8 step lo.hi and hi.lo go into the f32 accumulator before hi.hi
(for p.v into a zero accumulator, whose block sum is then added to the
output); the softmax is f32, online over tiles of 32 keys.
``emulate_fused_mha`` repeats that in plain torch (f32 sums of each k8
block's exact TF32 products), and the tests hold it within the card tests'
tolerance, 1e-5 * (1 + |ref|), of the JAX Pallas ``fused_mha`` (interpret
mode) and of the port's ``mha_reference``, while the same emulation with
hi.hi alone (1xTF32) must fail that tolerance: the control that it bites.
The tensor core's own truncating adds are not modelled, so the emulation
cannot show the drift of a long chain of them (P V with O as the mma
accumulator); the kernel itself, truncation included, is held to
``mha_reference`` on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.ops.attention import fused_mha as jfused_mha
from radad_tpu_torch.ops.attention import mha_reference

KEYS = 32  # keys per shared-memory tile (fused_mha.cu kKeys)
TOL = 1e-5  # |err| <= TOL * (1 + |ref|), as tests/test_torch_cuda.py


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero: cvt.rna.tf32.f32, as the kernel writes it in integer ops."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mma(d, a, b, corrections=True):
    """d + a @ b over one k8 block as the kernel issues it: lo.hi, hi.lo,
    then hi.hi, each block sum (exact products, f32 adds) added to d."""
    ah, al = split(a)
    bh, bl = split(b)
    if corrections:
        d = d + al @ bh
        d = d + ah @ bl
    return d + ah @ bh


def emulate_fused_mha(q, k, v, num_heads, gate=None, pos_bias=None,
                      corrections=True):
    """The kernel's arithmetic on ``[B, T, D]`` f32 tensors (q pre-scaled)."""
    b, t, d = q.shape
    hd = d // num_heads

    def heads(x):
        return x.reshape(b, t, num_heads, hd).transpose(1, 2)  # [B,H,T,hd]

    qh, kh, vh = heads(q), heads(k), heads(v)
    m = torch.full((b, num_heads, t, 1), float("-inf"))
    l = torch.zeros((b, num_heads, t, 1))
    o = torch.zeros((b, num_heads, t, hd))
    for s0 in range(0, t, KEYS):
        s1 = min(s0 + KEYS, t)
        s = torch.zeros((b, num_heads, t, s1 - s0))
        for kk in range(0, hd, 8):
            s = mma(s, qh[..., kk:kk + 8],
                    kh[:, :, s0:s1, kk:kk + 8].transpose(-1, -2), corrections)
        if gate is not None:  # product rounded, then added
            s = s + gate.transpose(1, 2)[..., None] * pos_bias[None, :, :,
                                                               s0:s1]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        scale = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * scale + p.sum(-1, keepdim=True)
        o = o * scale
        for f in range(0, s1 - s0, 8):  # block sums, then added to o
            o = o + mma(torch.zeros_like(o), p[..., f:f + 8],
                        vh[:, :, s0 + f:min(s0 + f + 8, s1)], corrections)
        m = m_new
    return (o / l).transpose(1, 2).reshape(b, t, d)


def _inputs(rng, b, t, h, hd, saturate):
    """As the card tests: randn q, k, v with q scaled by hd^-0.5, gate in
    [1, 3], randn pos_bias. ``saturate``: keys of norm sqrt(hd), row t's
    query along key (37 t mod T): logit 80 there, 80 cos(angle) at the
    others, so that key dominates the row."""
    d = h * hd
    q, k, v = (rng.standard_normal((b, t, d)).astype(np.float32)
               for _ in range(3))
    q *= hd ** -0.5
    if saturate:
        kh = k.reshape(b, t, h, hd)
        kh = kh * (hd ** 0.5 / np.linalg.norm(kh, axis=-1, keepdims=True))
        k = kh.reshape(b, t, d).astype(np.float32)
        q = (80 / hd * kh[:, (37 * np.arange(t)) % t]).reshape(
            b, t, d).astype(np.float32)
    gate = (1.0 + 2.0 * rng.random((b, t, h))).astype(np.float32)
    pos = rng.standard_normal((h, t, t)).astype(np.float32)
    return q, k, v, gate, pos


def _rel_err(got, want) -> float:
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


# T = 7 (one partial key tile), 99 (the serving T: four tiles), 600 (19,
# crossing the JAX kernel's 512-row query tile), each at HD 16, 64, 80
# (hubert-xlarge: ten k8 steps) and 128; ``saturate`` at T = 130 (five
# tiles, the row's dominant key in any of them)
GRID = [(t, hd, False) for t in (7, 99, 600) for hd in (16, 64, 80, 128)] + [
    (130, 64, True)]


def _outputs(rng, t, hd, saturate, bias):
    """(JAX interpret-mode kernel, mha_reference, inputs as torch) at b = 2
    rows of h = 2 heads."""
    b, h = 2, 2
    q, k, v, gate, pos = _inputs(rng, b, t, h, hd, saturate)
    extra = dict(gate=gate, pos_bias=pos) if bias else {}
    jax_out = np.asarray(jfused_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, interpret=True,
        **{n: jnp.asarray(a) for n, a in extra.items()}))
    targs = [torch.as_tensor(a) for a in (q, k, v)]
    textra = {n: torch.as_tensor(a) for n, a in extra.items()}
    ref = mha_reference(*targs, h, **textra).numpy()
    return jax_out, ref, (*targs, h), textra


@pytest.mark.parametrize("bias", [False, True])
def test_3xtf32_emulation_within_tolerance(bias, rng):
    """Every (T, HD) of GRID, within the tolerance of both packages."""
    for t, hd, saturate in GRID:
        jax_out, ref, args, extra = _outputs(rng, t, hd, saturate, bias)
        got = emulate_fused_mha(*args, **extra).numpy()
        assert _rel_err(got, jax_out) <= TOL, (t, hd, saturate)
        assert _rel_err(got, ref) <= TOL, (t, hd, saturate)


def test_1xtf32_misses_tolerance(rng):
    """The control that the tolerance bites: hi.hi alone, at the serving
    T = 99 and HD = 64, is outside it for both bodies."""
    for bias in (False, True):
        _, ref, args, extra = _outputs(rng, 99, 64, False, bias)
        one = emulate_fused_mha(*args, corrections=False, **extra).numpy()
        assert _rel_err(one, ref) > 2 * TOL, bias


def test_split_reproduces_f32(rng):
    """hi + lo is x within 2^-22 relative, hi and lo each carry at most 10
    explicit mantissa bits (the low 13 bits zero), and the rounding is to
    nearest with ties away from zero, as cvt.rna.tf32.f32."""
    x = (rng.standard_normal(100_000)
         * 10.0 ** rng.uniform(-30, 30, 100_000)).astype(np.float32)
    xt = torch.as_tensor(x)
    hi, lo = split(xt)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (xt.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * xt.double().abs()).all())
    assert bool(((xt - hi).abs() <= 2.0 ** -11 * xt.abs()).all())
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    ties = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp,
                         1 + ulp / 2 - 2.0 ** -23], dtype=torch.float32)
    assert rna_tf32(ties).tolist() == [1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1.0]
