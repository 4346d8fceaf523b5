"""The tensor-core summation order of ``flat_topk``'s bf16 body on the CPU.

``csrc/flat_topk.cu`` (``fast_scan=True``) sums q.x as k16 tensor-core
block sums added into an f32 chain, and |x|^2 as 4 lanes' fmaf chains
joined by a shuffle tree. ``ops/topk_check.py::pair_scores(order="mma")``
bounds that order. Here a worst-case f32 emulation of it (each block's 16
exact products aligned to the largest and truncated to 24 bits, the sum
truncated again, then round-to-nearest f32 adds) stays within the bound,
and ``check_topk`` under that order still rejects a scan without the bf16
rounding and a value 1e-3 off. The JAX kernel's fast scan (Pallas,
interpret mode) passes the same check. The card runs the kernel itself in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.ops import topk as jtopk
from radad_tpu_torch.ops.topk import flat_topk_plain
from radad_tpu_torch.ops.topk_check import (CHAIN, MMA, U, check_topk,
                                            pair_scores)


def _trunc24(v: torch.Tensor) -> torch.Tensor:
    """``v`` (f64) truncated toward zero to 24 significant bits."""
    m, e = torch.frexp(v)
    return torch.ldexp(torch.trunc(m * 2.0 ** 24), e - 24)


def _mma_block(p: torch.Tensor) -> torch.Tensor:
    """Worst case of one zero-accumulator k16 product on the tensor core:
    the exact products ``p [..., 16]`` aligned to the largest one's 24-bit
    grid by truncation, summed, the sum truncated to 24 bits (f32)."""
    _, e = torch.frexp(p.abs().amax(-1, keepdim=True))
    ulp = torch.ldexp(torch.ones_like(p[..., :1]), e - 24)
    return _trunc24((torch.trunc(p / ulp) * ulp).sum(-1)).float()


def _mma_order_f32(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 emulation of the bf16 body's L2 score, pair by pair (``q [P,
    D]``, ``x [P, D]``, D % 64 == 0), then the wrapper's subtraction of its
    f32 |q|^2."""
    p = q.to(torch.bfloat16).double() * x.to(torch.bfloat16).double()
    blocks = _mma_block(p.unflatten(-1, (-1, 16)))  # [P, D / 16]
    acc = torch.zeros(q.shape[0], dtype=torch.float32)
    for j in range(blocks.shape[1]):
        acc = acc + blocks[:, j]  # round-to-nearest f32 add
    # |x|^2: lane t takes columns 2t, 2t+1, 8+2t, 9+2t of each block; over
    # a 64-column stage it chains its 16 squares by fmaf (one rounding a
    # column) and adds the chain to its running sum; a 2-level tree over
    # the lanes
    cols = x.unflatten(-1, (-1, 4, 2, 4, 2)).movedim(-2, -5).flatten(-3)
    lane = torch.zeros((x.shape[0], 4), dtype=torch.float32)
    for stage in range(cols.shape[2]):
        c = torch.zeros_like(lane)
        for s in range(16):
            v = cols[:, :, stage, s].double()
            c = (c.double() + v * v).float()
        lane = lane + c
    xsq = (lane[:, 0] + lane[:, 1]) + (lane[:, 2] + lane[:, 3])
    return (2.0 * acc - xsq) - q.square().sum(-1)


@pytest.mark.parametrize("data", ["randn", "positive", "offset"])
def test_mma_bound_holds_for_a_worst_case_emulation(data, rng):
    """At the serving width D = 5,376: the emulation's error is within the
    ``"mma"`` bound, also where the partial sums grow without cancelling
    (positive data) and on large norms; the bound stays far below the
    order-free worst case gamma_D * sum|terms|."""
    p, d = 24, 5376
    q = rng.standard_normal((p, d)).astype(np.float32)
    x = rng.standard_normal((p, d)).astype(np.float32)
    if data == "positive":
        q, x = np.abs(q), np.abs(x)
    elif data == "offset":
        x += 30.0
    tq, tx = torch.as_tensor(q), torch.as_tensor(x)
    exact, bound = pair_scores(tq, tx, torch.arange(p)[:, None], order=MMA)
    err = (_mma_order_f32(tq, tx).double() - exact[:, 0]).abs()
    assert bool((err <= bound[:, 0]).all()), float((err / bound[:, 0]).max())
    qb = tq.to(torch.bfloat16).double()
    terms = (2.0 * (qb * tx.to(torch.bfloat16).double()).abs()
             + tx.double().square()).sum(-1) + tq.double().square().sum(-1)
    assert bool((bound[:, 0] < 0.05 * d * U * terms).all())


def test_orders_differ_only_in_their_bound(rng):
    """Both orders give the same exact value (up to the f64 sum's own
    order); the bounds differ."""
    q = torch.as_tensor(rng.standard_normal((5, 516)).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal((40, 516)).astype(np.float32))
    rows = torch.as_tensor(rng.integers(0, 40, (5, 7)))
    for metric in ("L2", "IP"):
        ec, bc = pair_scores(q, x, rows, metric=metric, order=CHAIN)
        em, bm = pair_scores(q, x, rows, metric=metric, order=MMA)
        torch.testing.assert_close(ec, em, rtol=1e-13, atol=0.0)
        assert not torch.equal(bc, bm) and bool((bm > 0).all())
    with pytest.raises(ValueError):
        pair_scores(q, x, rows, order="tree")


@pytest.mark.parametrize("fault", ["none", "unrounded", "value"])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_mma_order_check_catches_faults(metric, fault, rng):
    """``check_topk`` under the ``"mma"`` order passes the plain version and
    fails a scan without the bf16 rounding and a value 1e-3 off."""
    n, d, b = 700, 96, 9
    tq = torch.as_tensor(rng.standard_normal((b, d)).astype(np.float32))
    tx = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32))
    kw = dict(metric=metric, n_valid=650,
              ids=torch.arange(n, dtype=torch.int32) % 97,
              exclude_ids=torch.arange(b, dtype=torch.int32))
    v, i = flat_topk_plain(tq, tx, 32, fast_scan=fault != "unrounded", **kw)
    if fault == "value":
        v = v.clone()
        v[2, 0] += 1e-3
    out = check_topk(tq, tx, (v, i), fast_scan=True, order=MMA, **kw)
    assert out["ok"] == (fault == "none"), out
    assert fault == "none" or any("off its exact score" in m
                                  for m in out["problems"]), out
    if fault == "none":
        assert out["max_abs_err"] <= out["max_bound"] < 1e-2
        assert out["max_ratio"] <= 1.0


def test_unrounded_control_fails_a_looser_mma_bound(rng):
    """At D = 5,376 a scan without the bf16 rounding is off its bf16-operand
    scores by more than 4 times the ``"mma"`` bound: a bound 4 times looser
    would still reject it."""
    n, d, b = 256, 5376, 4
    tq = torch.as_tensor(rng.standard_normal((b, d)).astype(np.float32))
    tx = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32))
    unrounded = flat_topk_plain(tq, tx, 8, fast_scan=False)
    out = check_topk(tq, tx, unrounded, fast_scan=True, order=MMA)
    assert not out["ok"] and out["max_ratio"] > 4.0, out


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_jax_fast_scan_passes_the_mma_order_check(metric, rng):
    """The JAX kernel's bf16 scan (Pallas, interpret mode) on the same
    numpy inputs is held by the same check as the CUDA bf16 body."""
    n, d, b = 600, 128, 6
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    jv, ji = jtopk.flat_topk(jnp.asarray(q), jnp.asarray(x), 16,
                             metric=metric, n_valid=580, tile_n=256,
                             chunk_d=64, interpret=True, fast_scan=True)
    res = (torch.as_tensor(np.asarray(jv)),
           torch.as_tensor(np.asarray(ji)).to(torch.int32))
    out = check_topk(torch.as_tensor(q), torch.as_tensor(x), res,
                     metric=metric, n_valid=580, fast_scan=True,
                     order=MMA)
    assert out["ok"], out
