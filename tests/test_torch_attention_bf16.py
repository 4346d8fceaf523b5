"""The rounding of ``radad_tpu_torch/csrc/fused_mha.cu``'s bf16 bodies on
the CPU.

The bf16 bodies take bf16 q, k, v (gate, pos_bias), form S = Q Kᵀ in f32
on the tensor cores (one m16n8k16 product a step, exact bf16 products) and
add gate × pos_bias in f32. Then, in one of two forms (the wrapper's
``bf16_form`` picks by shape):
- resident (T <= 128, head width <= 80): the whole row of S in registers,
  the exact row max m, e = 2^(s·log2(e) − m·log2(e)) (one FMA, ex2, results
  below 2⁻¹²⁶ flushed to 0), the row sum l in the kernel's order (each lane
  adds its key pairs 8f + 2c, 8f + 2c + 1 over the fragments f, then the
  four lanes of the quad pairwise), and p = e · (1/l) rounded to bf16; each
  k16 step's P·V block sum (f32) goes into O by round-to-nearest f32 adds;
- streamed (otherwise): one pass over tiles of 64 keys with an online
  softmax. Per tile: the new row max m (the running max and the tile's),
  the scale 2^((m_old − m)·log2(e)) applied to O and to each lane's
  partial sum l, e = 2^(s·log2(e) − m·log2(e)) as above, the lane's key
  pairs added to its l in fragment order, e rounded to bf16 as the weights
  and O += P·V over k16 blocks; at the end l over the quad pairwise and
  O · (1/l). The card accumulates O in the tensor core's accumulator, which
  truncates where the emulation rounds: at most ~T/16 · 2⁻²³ relative
  (1.1e-5 at T = 1,500), far below the output's bf16 rounding, so the
  emulation rounds.
O is stored in bf16. ``emulate_bf16`` repeats that in plain torch, and the
tests hold it to the kernel's plain version (``fused_mha_plain``) and to
JAX's Pallas ``fused_mha`` in interpret mode within the card tests'
tolerance, BF16_TOL · (1 + |plain|). Faulty emulations must fail it: P·V
accumulated in bf16, an online softmax without the rescale of O when the
row max grows, a two-pass softmax that normalizes by a stale max, a
resident form whose row max and sum cover only the first 64 keys, and the
streamed form without the rescale of O or of l. Two designs the kernel did
not take stay within it too: the online softmax with exp and a division
at the end over 32-key tiles, and two passes over the keys that round the
normalized weights (PR 8's streamed form).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.ops.attention import fused_mha as jfused_mha
from radad_tpu_torch.ops.attention import BF16_TOL, bf16_form, fused_mha_plain

KEYS = 64  # keys per K/V tile of the streamed form (kStrKeys)
OLD_KEYS = 32  # the key tiles of the two-pass and plain online designs
K16 = 16   # keys per P·V product (mma.sync m16n8k16)
LOG2E = np.float32(1.4426950408889634)
BF = torch.bfloat16


def _bf(x: torch.Tensor) -> torch.Tensor:
    """f32 → bf16 (round to nearest even) → f32."""
    return x.to(BF).float()


def _row_sum_quad(e):
    """The resident form's row sum of ``e [..., T]`` (f32): lane c adds
    e[8f + 2c] + e[8f + 2c + 1] to its partial over the fragments f in
    order, then the quad adds (l0 + l1) + (l2 + l3)."""
    t = e.shape[-1]
    nf = -(-t // 8)
    pad = torch.zeros(e.shape[:-1] + (8 * nf - t,))
    pairs = torch.cat([e, pad], -1).reshape(e.shape[:-1] + (nf, 4, 2))
    pairs = pairs[..., 0] + pairs[..., 1]  # [..., nf, 4], f32
    part = torch.zeros(e.shape[:-1] + (4,))
    for f in range(nf):
        part = part + pairs[..., f, :]
    return ((part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3]))[
        ..., None]


def _exp_shifted(s, m):
    """e = 2^(s·log2(e) − m·log2(e)) as the resident form: m·log2(e) in
    f32, one FMA (an f64 product of two f32 values is exact), ex2 with
    results below 2⁻¹²⁶ flushed to 0."""
    ms = (m * LOG2E).double()
    e = torch.exp2((s.double() * float(LOG2E) - ms).float())
    return torch.where(e < 2.0 ** -126, torch.zeros_like(e), e)


def _lane_pairs(e):
    """``e [..., n]`` (n <= 64, a key tile) → each lane's key pairs
    e[8f + 2c] + e[8f + 2c + 1] in f32, ``[..., fragments, 4 lanes]``."""
    n = e.shape[-1]
    nf = -(-n // 8)
    pad = torch.zeros(e.shape[:-1] + (8 * nf - n,))
    pairs = torch.cat([e, pad], -1).reshape(e.shape[:-1] + (nf, 4, 2))
    return pairs[..., 0] + pairs[..., 1]


def emulate_bf16(q, k, v, num_heads, gate=None, pos_bias=None, *,
                 softmax=None, pv="rn_blocks"):
    """The bf16 kernel's arithmetic on bf16 ``[B, T, D]`` tensors (q
    pre-scaled) → bf16 ``[B, T, D]``. ``softmax``: None (the form the
    kernel takes at this shape: "one_pass" at T <= 128 and head width <=
    80, else "streamed"), "one_pass" (the resident form), "streamed" (the
    streamed form: online over 64-key tiles, ex2, l per lane), "two_pass"
    (PR 8's streamed form: max and sum over 32-key tiles, then normalized
    weights), "online" (exp, unnormalized weights rounded, O rescaled,
    divided at the end, 32-key tiles), and faults: "online_no_rescale"
    ("online" without the rescale of O), "stale_max" (pass 2 normalizes by
    the first tile's max), "first64" (the resident form with the row max
    and sum over the first 64 keys only), "streamed_no_rescale" (the
    streamed form without the rescale of O when the max grows),
    "streamed_stale_l" (the streamed form without the rescale of l: l
    summed against stale maxima). ``pv``: "rn_blocks" (each k16 block sum
    added to O by an RN add) or "bf16" (a fault: O rounded to bf16 after
    every block)."""
    b, t, d = q.shape
    hd = d // num_heads
    if softmax is None:
        softmax = {"resident": "one_pass",
                   "streamed": "streamed"}[bf16_form(t, hd)]

    def heads(x):
        return x.float().reshape(b, t, num_heads, hd).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)

    def tiles(width):
        return [(s0, min(s0 + width, t)) for s0 in range(0, t, width)]

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

    def heads_out(o):
        return o.transpose(1, 2).reshape(b, t, d).to(BF)

    m = torch.full((b, num_heads, t, 1), float("-inf"))
    l = torch.zeros((b, num_heads, t, 1))
    o = torch.zeros((b, num_heads, t, hd))
    if softmax in ("one_pass", "first64"):
        s = scores(0, t)
        span = s if softmax == "one_pass" else s[..., :64]
        m = span.amax(-1, keepdim=True)
        e = _exp_shifted(s, m)
        l = _row_sum_quad(e if softmax == "one_pass" else e[..., :64])
        p = _bf(e * (1.0 / l))
        return heads_out(add_pv(o, p, 0, t))
    if softmax.startswith("streamed"):
        lanes = torch.zeros((b, num_heads, t, 4))  # each lane's partial l
        for s0, s1 in tiles(KEYS):
            s = scores(s0, s1)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            scale = torch.exp2(((m - m_new) * LOG2E).double()).float()
            e = _exp_shifted(s, m_new)
            if softmax != "streamed_stale_l":
                lanes = lanes * scale
            pairs = _lane_pairs(e)
            for f in range(pairs.shape[-2]):  # the lane's pairs in order
                lanes = lanes + pairs[..., f, :]
            if softmax != "streamed_no_rescale":
                o = o * scale
            o = add_pv(o, _bf(e), s0, s1)
            m = m_new
        l = ((lanes[..., 0] + lanes[..., 1])
             + (lanes[..., 2] + lanes[..., 3]))[..., None]
        return heads_out(o * (1.0 / l))
    if softmax in ("two_pass", "stale_max"):
        first = None
        for s0, s1 in tiles(OLD_KEYS):  # pass 1
            s = scores(s0, s1)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(
                -1, keepdim=True)
            m = m_new
            first = m if first is None else first
        use = first if softmax == "stale_max" else m
        for s0, s1 in tiles(OLD_KEYS):  # pass 2
            p = _bf(torch.exp(scores(s0, s1) - use) / l)
            o = add_pv(o, p, s0, s1)
        return heads_out(o)
    for s0, s1 in tiles(OLD_KEYS):
        s = scores(s0, s1)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        scale = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * scale + p.sum(-1, keepdim=True)
        if softmax == "online":
            o = o * scale
        o = add_pv(o, _bf(p), s0, s1)
        m = m_new
    return heads_out(o / l)


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


def test_emulated_tile_width_is_the_kernels():
    """The emulation's key tile is both streamed bodies' (kStrKeys for the
    mma.sync body, kWgKeys for the wgmma one at head width 64), read from
    the source."""
    import os
    import re

    import radad_tpu_torch

    src = open(os.path.join(os.path.dirname(radad_tpu_torch.__file__),
                            "csrc", "fused_mha.cu")).read()
    for name in ("kStrKeys", "kWgKeys"):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == KEYS, name


def _worst(got, want) -> float:
    """max |got - want| / (1 + |want|), in f32."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (1 + want.abs())).max())


GRID = [(99, 64), (600, 64), (1500, 64), (99, 80), (130, 16)]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("t,hd", GRID + [(128, 64), (129, 64), (99, 128),
                                         (200, 128)])
def test_bf16_emulation_within_tolerance(t, hd, bias, rng):
    """The emulation of the form the kernel takes at each shape against
    the plain version, BF16_TOL · (1 + |plain|): the resident form at the
    serving T = 99 (head widths 64 and 80) and at T = 128, its largest;
    the streamed form at T = 129 (three key tiles, the last with 1 key),
    600 and 1,500, at head width 128 (T = 99 and 200), and for a 16-wide
    head at T = 130; at T <= 200 also against JAX's Pallas kernel in
    interpret mode. Measured: the resident form at most 1.4e-3
    (1 + |plain|), where the f32 sums of kernel and plain version put a
    weight or an output on the other side of a bf16 rounding tie (on the
    card 5.0e-3, its tensor cores' truncating sums included); the streamed
    form at most 5.2e-3, from rounding each weight before the division by
    l."""
    (q, k, v), extra = _inputs(rng, 2, t, 2, hd, bias)
    got = emulate_bf16(q, k, v, 2, **extra)
    want = fused_mha_plain(q, k, v, 2, **extra)
    assert got.dtype == want.dtype == BF
    assert _worst(got, want) <= BF16_TOL, (t, hd, bias, _worst(got, want))
    if t <= 200:
        jax_out = jfused_mha(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                               for x in (q, k, v)), 2, interpret=True,
                             **{n: jnp.asarray(x.float().numpy(),
                                               jnp.bfloat16)
                                for n, x in extra.items()})
        jax_out = torch.as_tensor(np.asarray(jax_out.astype(jnp.float32)))
        assert _worst(got, jax_out) <= BF16_TOL


def test_online_softmax_also_within_tolerance(rng):
    """Two designs the kernel did not take lie within the tolerance as well
    at the serving T = 99 and at T = 1,500 (both bodies): the online
    softmax in its plain form (exp, unnormalized weights rounded, one
    division at the end, 32-key tiles; measured 5.2e-3, as the streamed
    form) and PR 8's two passes over the keys, which round the normalized
    weights (measured 1.5e-3) at the cost of a second Q Kᵀ."""
    for t in (99, 1500):
        for bias in (False, True):
            (q, k, v), extra = _inputs(rng, 2, t, 2, 64, bias)
            want = fused_mha_plain(q, k, v, 2, **extra)
            for softmax in ("online", "two_pass"):
                got = emulate_bf16(q, k, v, 2, softmax=softmax, **extra)
                assert _worst(got, want) <= BF16_TOL, (t, bias, softmax)


@pytest.mark.parametrize("fault", ["pv_bf16", "online_no_rescale",
                                   "stale_max", "first64",
                                   "streamed_no_rescale",
                                   "streamed_stale_l"])
def test_faulty_emulations_fail(fault, rng):
    """The tolerance bites: each fault misses it, both bodies. At T = 1,500
    (24 tiles of 64 keys, 47 of 32; the row max grows across them): the
    streamed form with P·V accumulated in bf16 loses a term whenever it
    falls below half a step of the running sum (measured 3.5e-2 with
    |O| ~ 3); the plain online softmax without the rescale of O 1.3, the
    two-pass form with a stale max 7.0; the streamed form without the
    rescale of O 0.77, without that of l (l summed against stale maxima)
    0.18. At T = 128, the resident form with the row max and sum over the
    first 64 keys only: its weights do not sum to 1 (measured 0.7-35 ·
    (1 + |plain|) at T = 99 and 128)."""
    kw = dict(pv="bf16") if fault == "pv_bf16" else dict(softmax=fault)
    t = 128 if fault == "first64" else 1500
    for bias in (False, True):
        (q, k, v), extra = _inputs(rng, 2, t, 2, 64, bias)
        if fault == "pv_bf16":
            v = (v.float() + 3.0).to(BF)  # an offset: |O| ~ 3
        got = emulate_bf16(q, k, v, 2, **kw, **extra)
        want = fused_mha_plain(q, k, v, 2, **extra)
        assert _worst(got, want) > 2 * BF16_TOL, (fault, bias,
                                                   _worst(got, want))
