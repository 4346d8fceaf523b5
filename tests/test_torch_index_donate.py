"""``FlatIndex.add(..., donate=True)`` and ``FlatIndex(single_buffer=True)``
in the port against the JAX package on the CPU: the zero-copy install of a
first add (the caller's tensor becomes the stored rows) and the copy in
every other case, bf16 rows kept bf16 for bf16 storage, searches equal to
the JAX package's donated installs (flat f32, bf16 single-buffer, IVF with
a padded capacity; ``tests/test_index.py::test_add_donate_bf16_zero_copy``),
and ``single_buffer`` through the index files both ways."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.index.flat import FlatIndex as JFlatIndex
from radad_tpu_torch.index.flat import FlatIndex

D, K = 128, 5


def _meta(n):
    return np.zeros(n, np.float32), [f"f{i}.wav" for i in range(n)]


def _index(bf16: bool, metric: str = "L2", **kw):
    return FlatIndex(D, metric, use_float16=bf16, single_buffer=bf16,
                     device="cpu", **kw)


@pytest.mark.parametrize("bf16", [False, True])
def test_donated_first_add_is_adopted(bf16, rng):
    n = 2048  # a multiple of 1,024: no capacity padding
    x = torch.as_tensor(rng.standard_normal((n, D)).astype(np.float32))
    if bf16:
        x = x.to(torch.bfloat16)
    ix = _index(bf16)
    ix.add(x, *_meta(n), donate=True)
    assert ix.vectors is x and ix.vectors.data_ptr() == x.data_ptr()
    assert ix.single_buffer is bf16
    if bf16:  # bf16 storage: the scan copy is the stored rows
        assert ix.scan_bf16 is x and ix.resid_bf16 is None
    assert torch.equal(ix.norms_sq[:n], x.float().square().sum(-1))
    # a later add copies, as in the JAX package (its _append_chunk)
    y = torch.as_tensor(rng.standard_normal((1024, D)).astype(np.float32))
    ix.add(y.to(x.dtype), *_meta(1024), donate=True)
    assert ix.ntotal == n + 1024
    assert torch.equal(ix.vectors[n:n + 1024], y.to(x.dtype))


@pytest.mark.parametrize("case", ["not_donated", "padded", "cast", "numpy",
                                  "strided", "cosine"])
def test_other_adds_copy(case, rng):
    n = 1500 if case == "padded" else 2048
    xs = rng.standard_normal((n, D)).astype(np.float32)
    x = torch.as_tensor(xs)
    bf16, metric = case == "cast", "COSINE" if case == "cosine" else "L2"
    if case == "strided":
        x = torch.as_tensor(np.ascontiguousarray(xs.T)).t()
    rows = xs if case == "numpy" else x
    ix = _index(bf16, metric)
    ix.add(rows, *_meta(n), donate=case != "not_donated")
    assert ix.vectors.data_ptr() != x.data_ptr()
    assert ix.vectors.shape[0] == max(2048, ix.ntotal)
    np.testing.assert_array_equal(x.numpy(), xs)  # the caller's rows kept
    want = x.to(ix.vectors.dtype)
    if metric == "COSINE":
        want = want / want.norm(dim=-1, keepdim=True)
    torch.testing.assert_close(ix.vectors[:n], want, rtol=0, atol=1e-7)


def test_single_buffer_needs_bf16_storage_as_jax():
    for bf16 in (False, True):
        port = FlatIndex(D, use_float16=bf16, single_buffer=True,
                         device="cpu")
        jax_ = JFlatIndex(D, use_float16=bf16, single_buffer=True)
        assert port.single_buffer is jax_.single_buffer is bf16


CASES = {  # (metric, bf16 rows and storage, rows, JAX / port keywords)
    "flat_f32": ("L2", False, 2048, {}),
    "bf16_single_buffer": ("L2", True, 2048, {}),
    "ivf_padded_bf16": ("IVF", True, 1500,
                        dict(nlist=8, nprobe=8, kmeans_iters=4)),
}


def _pair(case, rng):
    """The same rows added with donate=True to a JAX FlatIndex and to the
    port's; every IVF cell is probed, so k-means' own start (which differs
    by design) leaves the neighbors as they are."""
    metric, bf16, n, kw = CASES[case]
    x = rng.standard_normal((n, D)).astype(np.float32)
    jx = JFlatIndex(D, metric, use_float16=bf16, single_buffer=bf16,
                    use_pallas=False, **kw)
    jx.add(jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32), *_meta(n),
           donate=True)
    tx = _index(bf16, metric, **kw)
    rows = torch.as_tensor(x)
    tx.add(rows.to(torch.bfloat16) if bf16 else rows, *_meta(n),
           donate=True)
    return jx, tx


def _same_search(jx, tx, q):
    jd, ji = jx.search(q, K)
    td, ti = tx.search(q, K)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_donated_search_matches_jax(case, rng):
    jx, tx = _pair(case, rng)
    assert tx.ntotal == jx.ntotal and tx.vectors.dtype == (
        torch.bfloat16 if CASES[case][1] else torch.float32)
    if case == "ivf_padded_bf16":
        assert tx.centroids is not None and tx.vectors.shape[0] == 2048
    _same_search(jx, tx, rng.standard_normal((8, D)).astype(np.float32))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_single_buffer_index_files_cross(writer, rng, tmp_path):
    jx, tx = _pair("bf16_single_buffer", rng)
    (tx if writer == "port" else jx).save(str(tmp_path))
    with open(os.path.join(tmp_path, "index_meta.json")) as f:
        assert json.load(f)["single_buffer"] is True
    if writer == "port":
        jx = JFlatIndex.load(str(tmp_path), use_pallas=False)
        assert jx.single_buffer
    else:
        tx = FlatIndex.load(str(tmp_path), device="cpu")
        assert tx.single_buffer and tx.use_float16
    _same_search(jx, tx, rng.standard_normal((8, D)).astype(np.float32))
