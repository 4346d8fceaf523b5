"""The rounding of ``radad_tpu_torch/csrc/fused_mha.cu``'s bf16 bodies on
the CPU.

The bf16 bodies take bf16 q, k, v (gate, pos_bias), form S = Q Kᵀ in f32
on the tensor cores (one m16n8k16 product a step, exact bf16 products), add
gate × pos_bias in f32, and take a two-pass softmax over tiles of 32 keys:
pass 1 finds each row's max m and sum l (online over the tiles), pass 2
forms the normalized weights p = exp(s − m) / l, rounds them to bf16, and
adds each k16 step's P·V block sum (f32) to O with round-to-nearest f32
adds; O is stored in bf16. ``emulate_bf16`` repeats that in plain torch,
and the tests hold it to the kernel's plain version (``fused_mha_plain``)
and to JAX's Pallas ``fused_mha`` in interpret mode within the card tests'
tolerance, BF16_TOL · (1 + |plain|). Faulty emulations must fail it: P·V
accumulated in bf16, the online softmax without the rescale of O when the
row max grows, and a second pass that normalizes by a stale max.
The online softmax as such (unnormalized weights rounded, one division at
the end: the design the kernel did not take) stays within it too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.ops.attention import fused_mha as jfused_mha
from radad_tpu_torch.ops.attention import BF16_TOL, fused_mha_plain

KEYS = 32  # keys per shared-memory tile (fused_mha.cu kKeys)
K16 = 16   # keys per P·V product (mma.sync m16n8k16)
BF = torch.bfloat16


def _bf(x: torch.Tensor) -> torch.Tensor:
    """f32 → bf16 (round to nearest even) → f32."""
    return x.to(BF).float()


def emulate_bf16(q, k, v, num_heads, gate=None, pos_bias=None, *,
                 softmax="two_pass", pv="rn_blocks"):
    """The bf16 kernel's arithmetic on bf16 ``[B, T, D]`` tensors (q
    pre-scaled) → bf16 ``[B, T, D]``. ``softmax``: "two_pass" (as built),
    "online" (unnormalized weights rounded, O rescaled, divided at the
    end), "online_no_rescale" (a fault), "stale_max" (a fault: pass 2
    normalizes by the first tile's max). ``pv``: "rn_blocks" (as built) or
    "bf16" (a fault: O rounded to bf16 after every block)."""
    b, t, d = q.shape
    hd = d // num_heads

    def heads(x):
        return x.float().reshape(b, t, num_heads, hd).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    tiles = [(s0, min(s0 + KEYS, t)) for s0 in range(0, t, KEYS)]

    def scores(s0, s1):
        s = torch.zeros((b, num_heads, t, s1 - s0))
        for kk in range(0, hd, 16):  # one k16 product a step, f32 adds
            s = s + qh[..., kk:kk + 16] @ kh[:, :, s0:s1, kk:kk + 16
                                             ].transpose(-1, -2)
        if gate is not None:  # product rounded, then added
            s = s + gate.float().transpose(1, 2)[..., None] * \
                pos_bias.float()[None, :, :, s0:s1]
        return s

    def add_pv(o, p, s0, s1):
        for f in range(0, s1 - s0, K16):  # block sums, then RN adds
            blk = p[..., f:f + K16] @ vh[:, :, s0 + f:min(s0 + f + K16, s1)]
            o = o + blk
            if pv == "bf16":
                o = _bf(o)
        return o

    m = torch.full((b, num_heads, t, 1), float("-inf"))
    l = torch.zeros((b, num_heads, t, 1))
    o = torch.zeros((b, num_heads, t, hd))
    if softmax in ("two_pass", "stale_max"):
        first = None
        for s0, s1 in tiles:  # pass 1
            s = scores(s0, s1)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(
                -1, keepdim=True)
            m = m_new
            first = m if first is None else first
        use = first if softmax == "stale_max" else m
        for s0, s1 in tiles:  # pass 2
            p = _bf(torch.exp(scores(s0, s1) - use) / l)
            o = add_pv(o, p, s0, s1)
    else:
        for s0, s1 in tiles:
            s = scores(s0, s1)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            scale = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * scale + p.sum(-1, keepdim=True)
            if softmax == "online":
                o = o * scale
            o = add_pv(o, _bf(p), s0, s1)
            m = m_new
        o = o / l
    return o.transpose(1, 2).reshape(b, t, d).to(BF)


def _inputs(rng, b, t, h, hd, bias):
    """bf16 q, k, v as the card tests (randn, q scaled by hd^-0.5), gate in
    [1, 3], randn pos_bias."""
    d = h * hd
    q, k, v = (rng.standard_normal((b, t, d)).astype(np.float32)
               for _ in range(3))
    q *= hd ** -0.5
    extra = {}
    if bias:
        extra = dict(gate=(1.0 + 2.0 * rng.random((b, t, h))).astype(
            np.float32), pos_bias=rng.standard_normal((h, t, t)).astype(
            np.float32))
    args = [torch.as_tensor(a).to(BF) for a in (q, k, v)]
    return args, {n: torch.as_tensor(a).to(BF) for n, a in extra.items()}


def _worst(got, want) -> float:
    """max |got - want| / (1 + |want|), in f32."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (1 + want.abs())).max())


GRID = [(99, 64), (600, 64), (1500, 64), (99, 80), (130, 16)]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("t,hd", GRID)
def test_bf16_emulation_within_tolerance(t, hd, bias, rng):
    """The two-pass emulation against the plain version, BF16_TOL · (1 +
    |plain|), at the serving T = 99, T = 600 and 1,500, head width 80 and
    a 16-wide head at T = 130 (five key tiles, the last with 2 keys); at
    T = 99 also against JAX's Pallas kernel in interpret mode. Measured:
    at most 2.5e-3 (1 + |plain|), where the f32 sums of kernel and plain
    version put a weight or an output on the other side of a bf16
    rounding tie (the kernel on the card: 5.0e-3, its tensor cores'
    truncating sums included)."""
    (q, k, v), extra = _inputs(rng, 2, t, 2, hd, bias)
    got = emulate_bf16(q, k, v, 2, **extra)
    want = fused_mha_plain(q, k, v, 2, **extra)
    assert got.dtype == want.dtype == BF
    assert _worst(got, want) <= BF16_TOL, (t, hd, bias, _worst(got, want))
    if t == 99:
        jax_out = jfused_mha(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                               for x in (q, k, v)), 2, interpret=True,
                             **{n: jnp.asarray(x.float().numpy(),
                                               jnp.bfloat16)
                                for n, x in extra.items()})
        jax_out = torch.as_tensor(np.asarray(jax_out.astype(jnp.float32)))
        assert _worst(got, jax_out) <= BF16_TOL


def test_online_softmax_also_within_tolerance(rng):
    """The design the kernel did not take, rounding unnormalized weights
    and dividing at the end, lies within the tolerance as well at the
    serving T = 99 and at T = 1,500 (both bodies; measured 5.2e-3, twice
    the two-pass form's error)."""
    for t in (99, 1500):
        for bias in (False, True):
            (q, k, v), extra = _inputs(rng, 2, t, 2, 64, bias)
            got = emulate_bf16(q, k, v, 2, softmax="online", **extra)
            want = fused_mha_plain(q, k, v, 2, **extra)
            assert _worst(got, want) <= BF16_TOL, (t, bias)


@pytest.mark.parametrize("fault", ["pv_bf16", "online_no_rescale",
                                   "stale_max"])
def test_faulty_emulations_fail(fault, rng):
    """The tolerance bites: each fault misses it at T = 1,500 (47 key tiles;
    the row max grows across them), both bodies. P·V accumulated in bf16
    loses a term whenever it falls below half a step of the running sum
    (measured 3.5e-2 with |O| ~ 3); without the rescale 1.07, with a stale
    max 6.96."""
    kw = {"pv_bf16": dict(pv="bf16"),
          "online_no_rescale": dict(softmax="online_no_rescale"),
          "stale_max": dict(softmax="stale_max")}[fault]
    for bias in (False, True):
        (q, k, v), extra = _inputs(rng, 2, 1500, 2, 64, bias)
        if fault == "pv_bf16":
            v = (v.float() + 3.0).to(BF)  # an offset: |O| ~ 3
        got = emulate_bf16(q, k, v, 2, **kw, **extra)
        want = fused_mha_plain(q, k, v, 2, **extra)
        assert _worst(got, want) > 2 * BF16_TOL, (fault, bias,
                                                   _worst(got, want))
