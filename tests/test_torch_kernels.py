"""The port's three kernels. On the CPU each wrapper runs its plain
version, which is held against the JAX function run as tests/test_index.py
runs it (Pallas interpret mode). The CUDA cases are in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.ops.gather import gather_rows as jgather
from radad_tpu.ops.gather import to_gather_layout
from radad_tpu.ops.rerank import exact_dot as jexact_dot
from radad_tpu.ops.rerank import exact_dot_reference
from radad_tpu.ops.topk import extract_candidates as jextract
from radad_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from radad_tpu_torch.ops.rerank import exact_dot, exact_dot_plain
from radad_tpu_torch.ops.topk import (extract_candidates,
                                      extract_candidates_plain)

I32 = torch.int32


def test_gather_rows_matches_pallas_interpret(rng):
    x = rng.standard_normal((100, 256)).astype(np.float32)
    idx = rng.integers(0, 100, size=20).astype(np.int32)
    want = np.asarray(jgather(jnp.asarray(x), jnp.asarray(idx),
                              interpret=True))
    got = gather_rows_plain(torch.as_tensor(x), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors: no launch
    before = gather_rows.launches
    assert torch.equal(gather_rows(torch.as_tensor(x), torch.as_tensor(idx)),
                       got)
    assert gather_rows.launches == before
    # out-of-range ids clamp like jnp.take's clip mode
    idx2 = np.asarray([-3, 0, 99, 150], np.int32)
    got2 = gather_rows(torch.as_tensor(x), torch.as_tensor(idx2)).numpy()
    np.testing.assert_array_equal(got2, x[np.clip(idx2, 0, 99)])
    # bf16 rows come back bit-equal
    xb = torch.as_tensor(x).to(torch.bfloat16)
    assert torch.equal(gather_rows(xb, torch.as_tensor(idx)),
                       xb[torch.as_tensor(idx).long()])


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_exact_dot_matches_pallas_interpret(dtype, rng):
    n, d, b, r = 96, 256, 7, 6
    x = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == "int8":
        x = rng.integers(-127, 128, (n, d)).astype(np.int8)
    q = rng.standard_normal((b, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, r)).astype(np.int32)
    tx = torch.as_tensor(x)
    if dtype == "bf16":
        tx = tx.to(torch.bfloat16)
        x = tx.float().numpy()  # the stored (rounded) rows are the truth
    got = exact_dot_plain(torch.as_tensor(q), tx,
                          torch.as_tensor(idx)).numpy()
    before = exact_dot.launches
    np.testing.assert_array_equal(
        exact_dot(torch.as_tensor(q), tx, torch.as_tensor(idx)).numpy(), got)
    assert exact_dot.launches == before
    if dtype == "f32":
        want = np.asarray(jexact_dot(
            jnp.asarray(q.reshape(b, d // 128, 128)),
            to_gather_layout(jnp.asarray(x)), jnp.asarray(idx),
            interpret=True))
    else:
        want = np.asarray(exact_dot_reference(
            jnp.asarray(q), jnp.asarray(x), jnp.asarray(idx)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("b,t,m", [(4, 8, 5), (30, 24, 8)])
def test_extract_candidates_matches_pallas_interpret(b, t, m, rng):
    """Bit-equal values, rows and leftover, with an all-(-inf) tile, an
    exact tie and a partly masked tile."""
    nt = 4 * t
    cand = rng.standard_normal((b, t, 128)).astype(np.float32)
    cand[0, 0, :] = -np.inf
    cand[1 % b, t - 1, 7] = cand[1 % b, t - 1, 99]
    cand[2 % b, 1, 10:60] = -np.inf
    cand[3 % b, 2, :] = 0.25  # a whole tile tied
    tsel = rng.integers(0, nt, size=(b, t)).astype(np.int32)
    want = jextract(jnp.asarray(cand), jnp.asarray(tsel), m, nt,
                    interpret=True)
    got = extract_candidates_plain(torch.as_tensor(cand),
                                   torch.as_tensor(tsel), m, nt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    before = extract_candidates.launches
    via = extract_candidates(torch.as_tensor(cand), torch.as_tensor(tsel),
                             m, nt)
    assert all(torch.equal(a, b) for a, b in zip(via, got))
    assert extract_candidates.launches == before
    assert got[0][0, 0] == -np.inf and got[1][0, 0] == tsel[0, 0]


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        gather_rows(x, torch.zeros(2, 2, dtype=I32))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(0, 8), torch.zeros(2, dtype=I32))
    with pytest.raises(ValueError):
        exact_dot(torch.zeros(2, 9), x, torch.zeros(2, 3, dtype=I32))
    with pytest.raises(ValueError):
        extract_candidates(torch.zeros(2, 3, 64), torch.zeros(2, 3, dtype=I32),
                           2, 4)
    with pytest.raises(ValueError):
        extract_candidates(torch.zeros(2, 3, 128),
                           torch.zeros(2, 3, dtype=I32), 0, 4)
