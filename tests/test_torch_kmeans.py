"""The port's k-means (radad_tpu_torch/index/ivf.py) and nearest-cell
assignment (index/flat.py::_assign_cells) against the JAX package's, on the
CPU: Lloyd from the same initial centroids, the balance rounds, and the
assignment in exact f32 with the lower cell on ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.index.flat import _assign_cells as jax_assign
from radad_tpu.index.ivf import _lloyd as jax_lloyd
from radad_tpu.index.ivf import kmeans as jax_kmeans
from radad_tpu_torch.index.flat import _assign_cells
from radad_tpu_torch.index.ivf import _lloyd, kmeans


def _clustered(seed, n=1200, d=64, k=12, spread=0.3, skew=False):
    """``n`` rows around ``k`` centres; ``skew``: cluster sizes ~ 1/i."""
    rng = np.random.default_rng(seed)
    centres = 4.0 * rng.standard_normal((k, d))
    p = 1.0 / np.arange(1, k + 1) if skew else np.ones(k)
    which = rng.choice(k, size=n, p=p / p.sum())
    x = centres[which] + spread * rng.standard_normal((n, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("nlist,iters", [(12, 25), (32, 10), (5, 1)])
def test_lloyd_matches_jax_from_same_start(nlist, iters):
    """Centroids within 1e-5 relative, assignments equal."""
    x = _clustered(nlist)
    init = x[np.random.default_rng(1).choice(len(x), nlist, replace=False)]
    jc, ja = jax_lloyd(jnp.asarray(x), jnp.asarray(init), nlist, iters)
    tc, ta = _lloyd(torch.as_tensor(x), torch.as_tensor(init), nlist, iters)
    jc = np.asarray(jc)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.dtype == torch.int32
    scale = np.abs(jc).max()
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5, atol=1e-5 * scale)


def test_lloyd_empty_cell_keeps_its_centroid():
    """A centroid far from every row gets no row and stays where it is."""
    x = _clustered(3, n=200, k=4)
    init = np.concatenate([x[:3], np.full((1, x.shape[1]), 1e3,
                                          np.float32)])
    tc, ta = _lloyd(torch.as_tensor(x), torch.as_tensor(init), 4, 5)
    jc, _ = jax_lloyd(jnp.asarray(x), jnp.asarray(init), 4, 5)
    assert not (ta.numpy() == 3).any()
    np.testing.assert_array_equal(tc.numpy()[3], init[3])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("balance", [0.0, 1.0])
def test_kmeans_deterministic_and_balance_runs(balance):
    """Same seed, same codebook and cells; another seed, another start. The
    balance rounds move centroids on skewed clusters (the count-weighted
    mean cell size drops), and both packages' kmeans reach a codebook of
    the same quality."""
    x = _clustered(7, n=2000, k=16, skew=True)
    xt = torch.as_tensor(x)
    c1, a1 = kmeans(xt, 16, iters=10, seed=3, balance=balance)
    c2, a2 = kmeans(xt, 16, iters=10, seed=3, balance=balance)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    c3, _ = kmeans(xt, 16, iters=10, seed=4, balance=balance)
    assert not torch.equal(c1, c3)
    assert c1.shape == (16, x.shape[1]) and a1.shape == (len(x),)
    np.testing.assert_array_equal(a1.numpy(), _assign_cells(xt, c1).numpy())
    if balance:
        plain, pa = kmeans(xt, 16, iters=10, seed=3)
        weighted = (lambda a: float((np.bincount(a.numpy(), minlength=16)
                                     ** 2).sum()) / len(x))
        assert not torch.equal(plain, c1)
        assert weighted(a1) < weighted(pa)
    jc, ja = jax_kmeans(jnp.asarray(x), 16, iters=10, seed=3,
                        balance=balance)

    def sse(c, a):
        c, a = np.asarray(c, np.float64), np.asarray(a)
        return float(((x - c[a]) ** 2).sum())

    assert sse(c1, a1) <= 1.5 * sse(jc, ja)


def test_kmeans_more_cells_than_rows():
    """nlist > n draws initial rows with replacement, as JAX does."""
    x = _clustered(9, n=6, d=8, k=2)
    c, a = kmeans(torch.as_tensor(x), 10, iters=3, seed=0)
    assert c.shape == (10, 8) and int(a.max()) < 10


@pytest.mark.parametrize("ties", [False, True])
def test_assign_cells_matches_jax(ties):
    """Exact f32 assignment; with duplicated centroids the lower cell
    wins in both packages."""
    rng = np.random.default_rng(11)
    x = _clustered(11, n=900, d=96, k=20)
    cents = x[rng.choice(len(x), 20, replace=False)].copy()
    if ties:
        cents[7] = cents[2]
        cents[19] = cents[0]
    want = np.asarray(jax_assign(jnp.asarray(x), jnp.asarray(cents)))
    got = _assign_cells(torch.as_tensor(x), torch.as_tensor(cents))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if ties:
        assert not np.isin(got.numpy(), [7, 19]).any()
