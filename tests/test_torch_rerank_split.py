"""The summation order of ``exact_dot``'s split form on the CPU.

``radad_tpu_torch/csrc/exact_dot.cu``'s split form (small B) gives each
(query, candidate row) one block of ``kSplitThreads`` lanes. Lane t takes
the row's 4-value units t, t + kSplitThreads, ... and sums q · x over them
with f32 FMA in unit order; the lane sums go over each warp by a shuffle
butterfly (xor 16, 8, 4, 2, 1) and one thread adds the warps' sums in warp
order. ``emulate_split`` repeats that in numpy, and the tests hold it to
JAX's Pallas ``exact_dot`` in interpret mode (as tests/test_torch_kernels.py
runs it) within the card's tolerance, 1e-5 · Σ|q_d x_d|, at the serving
widths D = 3,584 (whisper-base) and 5,376 (wav2vec2-base), for f32, bf16 and
int8 rows. A combine that drops one warp's sum must fail it.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radad_tpu_torch
from radad_tpu.ops.gather import to_gather_layout
from radad_tpu.ops.rerank import exact_dot as jexact_dot
from radad_tpu_torch.ops.rerank import (FORMS, SPLIT_MAX_B, exact_dot,
                                        exact_dot_form, exact_dot_plain)

THREADS = 256  # kSplitThreads
WARPS = THREADS // 32
TOL = 1e-5  # |err| <= TOL * sum_d |q_d x_d|, as chip_smoke.py and the card


def _fma(a, b, c):
    """f32 fma(a, b, c): the product of two f32 values is exact in f64,
    one rounding of the f64 sum to f32 (a double rounding, rare and far
    inside the tolerance)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_split(q, x, idx, drop_warp=None):
    """The split form's dots, ``q [B, D]`` f32, ``x [N, D]`` (as f32),
    ``idx [B, R]`` (clamped to [0, N)) → ``[B, R]`` f32. ``drop_warp``: a
    fault, the combine leaves out that warp's sum."""
    b, d = q.shape
    rows = x[np.clip(idx, 0, x.shape[0] - 1)].astype(np.float32)  # [B, R, D]
    units = d // 4
    acc = np.zeros(idx.shape + (THREADS,), np.float32)
    for u0 in range(0, units, THREADS):  # each lane's units in order
        n = min(THREADS, units - u0)
        xs = rows[..., 4 * u0:4 * (u0 + n)].reshape(idx.shape + (n, 4))
        qs = q[:, 4 * u0:4 * (u0 + n)].reshape(b, 1, n, 4)
        for e in range(4):
            acc[..., :n] = _fma(qs[..., e], xs[..., e], acc[..., :n])
    lanes = acc.reshape(idx.shape + (WARPS, 32))
    for o in (16, 8, 4, 2, 1):  # the shuffle butterfly
        lanes = lanes + lanes[..., np.arange(32) ^ o]
    warp_sums = lanes[..., 0]
    out = np.zeros(idx.shape, np.float32)
    for w in range(WARPS):  # warp order, one thread
        if w != drop_warp:
            out = out + warp_sums[..., w]
    return out


def _case(rng, kind, b, d, n=40, r=32):
    """q, the rows as stored (numpy; int8 as int8), the same as f32 (what
    the kernel reads), clamped ids, and ids with entries out of range."""
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if kind == "int8":
        x = rng.integers(-127, 128, (n, d)).astype(np.int8)
    if kind == "bf16":
        x = torch.as_tensor(x).to(torch.bfloat16).float().numpy()
    wide = rng.integers(-3, n + 3, (b, r)).astype(np.int32)
    return q, x, x.astype(np.float32), np.clip(wide, 0, n - 1), wide


def _scale(q, xf, idx):
    return (np.abs(xf[idx]) * np.abs(q)[:, None, :]).sum(-1)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [3584, 5376])
def test_split_order_matches_pallas_interpret(d, kind, rng):
    """The emulated split order against JAX's Pallas kernel (interpret
    mode) and against the port's plain version within 1e-5 · Σ|q·x|, with
    ids out of range (-3 .. N + 2) clamped as the kernel does."""
    q, x, xf, idx, wide = _case(rng, kind, 3, d)
    got = emulate_split(q, xf, wide)
    x3 = to_gather_layout(jnp.asarray(x if kind == "int8" else xf))
    want = np.asarray(jexact_dot(jnp.asarray(q.reshape(3, d // 128, 128)),
                                 x3, jnp.asarray(idx), interpret=True))
    scale = _scale(q, xf, idx)
    assert bool((np.abs(got - want) <= TOL * scale).all()), kind
    tx = torch.as_tensor(xf).to(torch.bfloat16) if kind == "bf16" else \
        torch.as_tensor(x)
    plain = exact_dot_plain(torch.as_tensor(q), tx,
                            torch.as_tensor(wide)).numpy()
    assert bool((np.abs(got - plain) <= TOL * scale).all()), kind


def test_dropped_warp_fails(rng):
    """The control: a combine that leaves out one warp's sum (1/8 of the
    row's units) misses the tolerance by far, at both widths."""
    for d in (3584, 5376):
        q, _, xf, idx, _ = _case(rng, "f32", 2, d)
        want = exact_dot_plain(torch.as_tensor(q), torch.as_tensor(xf),
                               torch.as_tensor(idx)).numpy()
        bad = emulate_split(q, xf, idx, drop_warp=WARPS - 1)
        err = np.abs(bad - want) / _scale(q, xf, idx)
        assert float(err.max()) > 100 * TOL, (d, float(err.max()))


def test_split_order_is_the_kernels():
    """The emulation's lane count is the kernel's (kSplitThreads, read from
    the source), and the combine is the one the source writes: a butterfly
    over the warp, then the warps' sums in order by one thread."""
    src = open(os.path.join(os.path.dirname(radad_tpu_torch.__file__),
                            "csrc", "exact_dot.cu")).read()
    found = re.search(r"constexpr int kSplitThreads = (\d+);", src)
    assert found and int(found.group(1)) == THREADS
    assert "for (int w = 1; w < kSplitThreads / 32; ++w) s += warp_sums[w];" \
        in src
    assert "atomicAdd" not in src and "atom." not in src


@pytest.mark.parametrize("b,want", [
    (1, "split"), (8, "split"), (64, "split"),  # serving: predict(_batch)
    (128, "per_query"), (256, "per_query"),  # train batch, eval batch
])
def test_exact_dot_form_by_path(b, want):
    """The form the wrapper picks at each path's B (R = max(32, 2k) = 32
    at top-5), at both serving widths; the threshold is SPLIT_MAX_B."""
    for d in (3584, 5376):
        assert exact_dot_form(b, 32, d) == want
    assert exact_dot_form(SPLIT_MAX_B, 32, 5376) == "split"
    assert exact_dot_form(SPLIT_MAX_B + 1, 32, 5376) == "per_query"
    assert set(FORMS) == {"per_query", "split"}


def test_cpu_tensors_take_the_plain_version(rng):
    """On the CPU the wrapper runs the plain version: no launch, no form
    counted."""
    q, _, xf, idx, _ = _case(rng, "f32", 2, 256)
    before = (exact_dot.launches, dict(exact_dot.form_launches))
    got = exact_dot(torch.as_tensor(q), torch.as_tensor(xf),
                    torch.as_tensor(idx))
    assert torch.equal(got, exact_dot_plain(torch.as_tensor(q),
                                            torch.as_tensor(xf),
                                            torch.as_tensor(idx)))
    assert (exact_dot.launches, exact_dot.form_launches) == before
