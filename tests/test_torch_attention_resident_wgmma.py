"""The arithmetic of the resident bf16 form's wgmma kernel on the CPU.

``radad_tpu_torch/csrc/fused_mha.cu``'s ``mha_bf16_resident_wgmma_kernel``
(head width 64, no bias, T <= 128) forms S = Q Kᵀ over N keys (T rounded up
to 64, 104 or 128; K rows past T are zero) in f32, one wgmma a k16 step;
sets keys >= T to -inf; takes the exact row max m, e = 2^(s·log2(e) −
m·log2(e)) and the row sum l in the resident form's order (each lane's key
pairs over the fragments, then the quad); rounds p = e · (1/l) to bf16; and
sums O = P·V over ceil(N / 16) k16 steps in ONE f32 accumulator (the
mma.sync resident kernel adds each step's block sum by an RN add instead),
then rounds O to bf16. ``emulate_resident_wgmma`` repeats that in plain
torch. The tensor core's accumulator truncates its adds: the emulation
rounds them and bounds the difference (``pv="rz"``, every add rounded
toward zero, stays within ceil(N / 16) · 2⁻²³ · Σ|p v| of it).

The tests hold the emulation to ``fused_mha_plain`` and to JAX's Pallas
``fused_mha`` in interpret mode within ``BF16_TOL`` · (1 + |plain|), the
card's tolerance, and two faults must miss it: keys in [T, N) left
unmasked (they enter the softmax with logit 0), and P·V accumulated in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.ops.attention import fused_mha as jfused_mha
from radad_tpu_torch.ops.attention import BF16_TOL, bf16_form, fused_mha_plain

BF = torch.bfloat16
LOG2E = np.float32(1.4426950408889634)
K16 = 16


def _bf(x):
    return x.to(BF).float()


def keys_of_s(t: int) -> int:
    """N, the keys of S: T rounded up to 64, 104 or 128 (the kernel's
    instances)."""
    return 64 if t <= 64 else 104 if t <= 104 else 128


def _round_toward_zero(x64):
    """f64 → the f32 value next to it toward zero."""
    x = x64.float()
    over = x.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x, torch.zeros_like(x)), x)


def emulate_resident_wgmma(q, k, v, num_heads, *, mask=True, pv="rn",
                           raw=False):
    """The kernel's arithmetic on bf16 ``[B, T, D]`` (q pre-scaled) → bf16
    ``[B, T, D]`` (f32 before the output's rounding where ``raw``).
    ``mask``: keys >= T to -inf (False: a fault, keys in [T, N) keep logit
    0). ``pv``: "rn" (the accumulator's adds rounded to nearest), "rz"
    (rounded toward zero, as the tensor core truncates), "bf16" (a fault:
    O rounded to bf16 after every k16 step)."""
    b, t, d = q.shape
    hd = d // num_heads
    n = keys_of_s(t)

    def heads(x, rows):
        x = x.float().reshape(b, t, num_heads, hd).transpose(1, 2)
        return torch.cat([x, torch.zeros(b, num_heads, rows - t, hd)], 2)

    qh, kh, vh = heads(q, t), heads(k, n), heads(v, -(-n // K16) * K16)
    s = torch.zeros(b, num_heads, t, n)
    for kk in range(0, hd, K16):  # one k16 step a wgmma, f32 adds
        s = s + qh[..., kk:kk + K16] @ kh[..., kk:kk + K16].transpose(-1, -2)
    if mask:
        s[..., t:] = float("-inf")
    m = s.amax(-1, keepdim=True)
    e = torch.exp2((s.double() * float(LOG2E)
                    - (m * LOG2E).double()).float())
    e = torch.where(e < 2.0 ** -126, torch.zeros_like(e), e)  # ex2.ftz
    pairs = e.reshape(b, num_heads, t, n // 8, 4, 2)
    pairs = pairs[..., 0] + pairs[..., 1]
    lane = torch.zeros(b, num_heads, t, 4)
    for f in range(n // 8):  # the lane's pairs over the fragments
        lane = lane + pairs[..., f, :]
    l_ = ((lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3]))
    p = _bf(e * (1.0 / l_[..., None]))
    p = torch.cat([p, torch.zeros(b, num_heads, t, vh.shape[2] - n)], -1)
    o = torch.zeros(b, num_heads, t, hd)
    for s0 in range(0, vh.shape[2], K16):  # one accumulator over the steps
        blk = (p[..., s0:s0 + K16].double()
               @ vh[:, :, s0:s0 + K16].double())
        if pv == "rz":
            o = _round_toward_zero(o.double() + blk)
        else:
            o = (o.double() + blk).float()
            if pv == "bf16":
                o = _bf(o)
    o = o.transpose(1, 2).reshape(b, t, d)
    return o if raw else o.to(BF)


def _inputs(rng, b, t, h, scale=1.0, offset=0.0):
    """bf16 q, k, v [b, t, 64 h] (q scaled by 64^-0.5 · ``scale``), v +
    ``offset``."""
    d = 64 * h
    q, k, v = (rng.standard_normal((b, t, d)).astype(np.float32)
               for _ in range(3))
    q *= 64 ** -0.5 * scale
    v += offset
    return [torch.as_tensor(a).to(BF) for a in (q, k, v)]


def _worst(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (1 + want.abs())).max())


def _jax(q, k, v, h):
    out = jfused_mha(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                       for x in (q, k, v)), h, interpret=True)
    return torch.as_tensor(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("t", [1, 15, 16, 17, 64, 65, 99, 100, 104, 105,
                               112, 113, 128])
def test_emulation_within_tolerance(t, rng):
    """Every T of the card test (each of the three N and their edges)
    against the plain version and JAX's Pallas kernel in interpret mode,
    BF16_TOL · (1 + |plain|); this is the form the wrapper takes there.
    Measured: at most 1.5e-3 · (1 + |plain|)."""
    q, k, v = _inputs(rng, 2, t, 2)
    assert bf16_form(t, 64) == "resident"
    got = emulate_resident_wgmma(q, k, v, 2)
    want = fused_mha_plain(q, k, v, 2)
    assert got.dtype == want.dtype == BF
    assert _worst(got, want) <= BF16_TOL, (t, _worst(got, want))
    assert _worst(got, _jax(q, k, v, 2)) <= BF16_TOL, t


@pytest.mark.parametrize("t", [99, 128])
def test_truncating_accumulator_bounded(t, rng):
    """The accumulator's adds truncated (every add toward zero) move O by at
    most ceil(N / 16) · 2⁻²³ · Σ|p v| from the rounded emulation, far below
    the output's bf16 step, and stay within the tolerance: saturating
    logits (q scaled 8×) and an offset V (|O| ~ 3). Measured: 3.3e-6 at
    T = 99."""
    q, k, v = _inputs(rng, 2, t, 2, scale=8.0, offset=3.0)
    rn = emulate_resident_wgmma(q, k, v, 2, raw=True)
    rz = emulate_resident_wgmma(q, k, v, 2, pv="rz", raw=True)
    steps = -(-keys_of_s(t) // K16)
    mass = 3.0 + 5.0  # >= sum_s p_s |v_s| here: sum p = 1, |v| < 3 + 5
    assert float((rn - rz).abs().max()) <= steps * 2.0 ** -23 * mass
    want = fused_mha_plain(q, k, v, 2)
    assert _worst(rz.to(BF), want) <= BF16_TOL


def test_unmasked_pad_keys_fail(rng):
    """A fault: keys in [T, N) enter the softmax with logit 0 (their K rows
    are zero). At T = 99 (N = 104: 5 such keys) with near-uniform weights
    and |O| ~ 3, O shrinks by ~5 %; at T = 65 (39 such keys) far more.
    Measured: 4.0e-2 and 0.27 · (1 + |plain|)."""
    for t, scale in ((99, 0.05), (65, 1.0)):
        q, k, v = _inputs(rng, 2, t, 2, scale=scale, offset=3.0)
        want = fused_mha_plain(q, k, v, 2)
        assert _worst(emulate_resident_wgmma(q, k, v, 2), want) <= BF16_TOL
        bad = emulate_resident_wgmma(q, k, v, 2, mask=False)
        assert _worst(bad, want) > 2 * BF16_TOL, (t, _worst(bad, want))


def test_bf16_accumulation_fails(rng):
    """A fault: O rounded to bf16 after every k16 step. V rows of +30 on the
    first 48 keys and -30 after (plus noise) with near-uniform weights: the
    partial sums reach ~15 (a bf16 step of 2⁻⁴) before they cancel to
    |O| ~ 1, so the roundings stay in the output, while one f32 accumulator
    keeps them below 1e-5. Measured: 6.6e-2 · (1 + |plain|)."""
    t = 99
    q, k, v = _inputs(rng, 2, t, 2, scale=0.05)
    sign = torch.where(torch.arange(t) < 48, 30.0, -30.0)[None, :, None]
    v = (v.float() + sign).to(BF)
    want = fused_mha_plain(q, k, v, 2)
    assert _worst(emulate_resident_wgmma(q, k, v, 2), want) <= BF16_TOL
    bad = emulate_resident_wgmma(q, k, v, 2, pv="bf16")
    assert _worst(bad, want) > 2 * BF16_TOL, _worst(bad, want)


def test_keys_of_s_are_the_kernels():
    """N follows the kernel's dispatch (64, 104, 128; read from the
    source), and 104 is the serving T = 99 and 100's."""
    import os

    import radad_tpu_torch

    src = open(os.path.join(os.path.dirname(radad_tpu_torch.__file__),
                            "csrc", "fused_mha.cu")).read()
    for n, cond in ((64, "t <= 64"), (104, "t <= 104")):
        assert (f"if ({cond}) return launch_resident_wgmma_n<{n}>" in src)
    assert "return launch_resident_wgmma_n<128>" in src
    assert keys_of_s(99) == keys_of_s(100) == 104
    assert [keys_of_s(t) for t in (1, 64, 65, 104, 105, 128)] == [
        64, 64, 104, 104, 128, 128]
