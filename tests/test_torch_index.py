"""Port flat index against the JAX package on the CPU: the certified
search, its near-tie fallback, the certificate on clustered rows, both
exclusion modes, chunked search, and index files written by either
package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.index import flat as jflat
from radad_tpu.ops import rerank as jrerank
from radad_tpu.ops.gather import to_gather_layout
from radad_tpu_torch.index import flat as tflat


@pytest.fixture
def interpret_rerank(monkeypatch):
    """Route the JAX rerank kernel through Pallas interpret mode, as
    tests/test_index.py does."""
    orig = jrerank.exact_dot
    monkeypatch.setattr(jrerank, "exact_dot",
                        lambda q3, x3, idx: orig(q3, x3, idx, interpret=True))


def _accel(x):
    """JAX accelerator arrays and the port's for rows ``x [cap, D]``."""
    xd = jnp.asarray(x)
    scan = xd.astype(jnp.bfloat16)
    jarr = dict(xsq=jnp.sum(jnp.square(xd), -1), scan_bf16=scan,
                gather3=to_gather_layout(xd),
                resid_bf16=(xd - scan.astype(jnp.float32)).astype(
                    jnp.bfloat16))
    xt = torch.as_tensor(x)
    st = xt.to(torch.bfloat16)
    tarr = dict(xsq=xt.square().sum(-1), scan_bf16=st,
                resid_bf16=(xt - st.float()).to(torch.bfloat16))
    return xd, jarr, xt, tarr


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("mode", ["batch", "self"])
def test_certified_search_matches_jax(metric, mode, rng, interpret_rerank):
    n, d, b, k, cap = 600, 256, 16, 5, 1024
    x = np.zeros((cap, d), np.float32)
    x[:n] = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "COSINE":
        x[:n] /= np.linalg.norm(x[:n], axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    ids = np.full((cap,), -1, np.int32)
    ids[:n] = np.arange(n) % 97
    excl = (np.arange(b) % 97).astype(np.int32)
    xd, jarr, xt, tarr = _accel(x)
    jd, ji = jflat._search_device(
        jnp.asarray(q), xd, jnp.asarray(ids), jnp.asarray(excl), k,
        metric=metric, n_valid=n, exclude_mode=mode, **jarr)
    td, ti, fell_back = tflat._search_device(
        torch.as_tensor(q), xt, torch.as_tensor(ids), torch.as_tensor(excl),
        k, metric=metric, n_valid=n, exclude_mode=mode, **tarr)
    assert not fell_back
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)
    excluded = ids[ti.numpy()]
    if mode == "self":
        assert not (excluded == excl[:, None]).any()
    else:
        assert not np.isin(excluded, excl).any()


@pytest.mark.parametrize("k,falls_back", [(5, False), (20, True)])
def test_near_tie_fallback_restores_recall(k, falls_back):
    """Mirror of tests/test_index.py::test_fast_exact_near_tie_certificate:
    101 rows tied within bf16 resolution packed into ONE strided tile.
    At k=20 more rows than the rerank depth (R=40) sit inside the
    certificate's margin, so the certificate fails and the f32 fallback
    must return the f64 oracle's neighbors; at k=5 the 32 exactly
    re-scored candidates already certify. Recall is 1.0 either way."""
    rng = np.random.default_rng(7)
    n, d, b, cap = 900, 256, 4, 1024
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = np.zeros((cap, d), np.float32)
    x[:n] = rng.standard_normal((n, d)).astype(np.float32) * 3.0
    base = q[0] + 0.5 * rng.standard_normal(d).astype(np.float32)
    nt = cap // 128
    for j in range(101):
        u = rng.standard_normal(d).astype(np.float32)
        x[j * nt] = base + 3e-3 * (101 - j) * u / np.linalg.norm(u)
    ids = torch.as_tensor(np.where(np.arange(cap) < n, np.arange(cap), -1)
                          .astype(np.int32))
    _, _, xt, tarr = _accel(x)
    _, got, fell_back = tflat._search_device(
        torch.as_tensor(q), xt, ids, torch.full((b,), -2, dtype=torch.int32),
        k, metric="L2", n_valid=n, **tarr)
    assert fell_back == falls_back
    d2 = ((q.astype(np.float64)[:, None, :]
           - x[None, :n, :].astype(np.float64)) ** 2).sum(-1)
    oracle = np.argsort(d2, axis=1)[:, :k]
    for row in range(b):
        assert set(got[row].tolist()) == set(oracle[row].tolist()), row

    index = tflat.FlatIndex(d, "L2", device="cpu")
    index.add(x[:n], [0.0] * n, [f"r{i}.wav" for i in range(n)],
              ids=list(range(n)))
    _, ii = index.search(q, k)
    assert index.fallbacks == int(falls_back) and index.searches == 1
    for row in range(b):
        assert set(ii[row].tolist()) == set(oracle[row].tolist()), row


def test_certificate_on_clustered_rows():
    """Mirror of test_certificate_holds_on_clustered_embeddings: contiguous
    tight clusters certify (strided tiles spread them); a stride-aligned
    cluster does not."""
    rng = np.random.default_rng(11)
    n, d, b, k, cap = 900, 256, 64, 5, 1024
    nt = cap // 128

    def run(x):
        xp = np.pad(x, ((0, cap - n), (0, 0)))
        _, _, xt, tarr = _accel(xp)
        mask = (torch.arange(cap) >= n)[None, :].expand(b, cap)
        dists, _, certified = tflat._search_fast_exact(
            torch.as_tensor(x[:b]), tarr["scan_bf16"], tarr["xsq"], mask, k,
            False, xt, resid_bf16=tarr["resid_bf16"])
        d2 = ((x[:b].astype(np.float64)[:, None, :]
               - x[None, :, :].astype(np.float64)) ** 2).sum(-1)
        want = np.sort(d2, axis=1)[:, :k]
        return certified, np.sort(dists.numpy(), axis=1), want

    centers = rng.standard_normal((30, d)).astype(np.float32) * 8.0
    x = np.concatenate([c + 0.05 * rng.standard_normal((30, d)).astype(
        np.float32) for c in centers])
    cert, got, want = run(x)
    assert cert
    np.testing.assert_allclose(got, want, atol=0.02)

    x2 = rng.standard_normal((n, d)).astype(np.float32) * 8.0
    u = rng.standard_normal(d).astype(np.float32)
    for j in range(60):
        x2[j * nt] = x2[0] + 0.01 * (60 - j) * u / np.linalg.norm(u)
    cert2, _, _ = run(x2)
    assert not cert2


def _jax_index(x, labels, paths, ids, **kw):
    index = jflat.FlatIndex(x.shape[1], "L2", **kw)
    index.add(x, labels, paths, ids=ids)
    return index


@pytest.mark.parametrize("use_float16", [False, True])
def test_index_files_interchange(use_float16, rng, tmp_path):
    """An index saved by the JAX package loads in the port with identical
    search results, and the reverse."""
    n, d = 1000, 256
    x = rng.standard_normal((n, d)).astype(np.float32)
    labels = (rng.random(n) > 0.5).astype(np.float32).tolist()
    paths = [f"/data/clip_{i:04d}.wav" for i in range(n)]
    ids = [int(i % 331) for i in range(n)]
    q = rng.standard_normal((12, d)).astype(np.float32)
    excl = np.arange(12, dtype=np.int32) * 7

    jidx = _jax_index(x, labels, paths, ids, use_float16=use_float16)
    jidx.save(str(tmp_path / "jax"))
    tidx = tflat.FlatIndex.load(str(tmp_path / "jax"), device="cpu")
    assert tidx.ntotal == n and tidx.paths == paths
    assert tidx.use_float16 == use_float16
    jd, ji = jidx.search(q, 5, exclude_ids=excl)
    td, ti = tidx.search(q, 5, exclude_ids=excl)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-3)
    assert tidx.fallbacks == 0

    tidx.save(str(tmp_path / "port"))
    back = jflat.FlatIndex.load(str(tmp_path / "port"))
    assert back.paths == paths and back.use_float16 == use_float16
    bd, bi = back.search(q, 5, exclude_ids=excl)
    np.testing.assert_array_equal(bi, ji)
    np.testing.assert_array_equal(np.asarray(back.ids)[:n],
                                  np.asarray(jidx.ids)[:n])


def test_incremental_add_and_chunked_search(rng):
    """Adds that grow capacity, and a search larger than search_chunk with
    one call-global exclusion set, equal the JAX index's results."""
    n, d = 1500, 128
    x = rng.standard_normal((n, d)).astype(np.float32)
    labels = [0.0] * n
    paths = [f"c{i}.wav" for i in range(n)]
    ids = list(range(n))
    tidx = tflat.FlatIndex(d, "L2", add_batch_size=300, device="cpu")
    tidx.add(x[:700], labels[:700], paths[:700], ids=ids[:700])
    tidx.add(x[700:], labels[700:], paths[700:], ids=ids[700:])
    assert tidx.ntotal == n and tidx.vectors.shape[0] == 2048
    jidx = _jax_index(x, labels, paths, ids)
    q = x[:50] + 0.01 * rng.standard_normal((50, d)).astype(np.float32)
    excl = np.arange(50, dtype=np.int32)
    tidx.search_chunk = 16
    td, ti = tidx.search(q, 4, exclude_ids=excl)
    jd, ji = jidx.search(q, 4, exclude_ids=excl)
    np.testing.assert_array_equal(ti, ji)
    assert not np.isin(ti, excl).any()  # call-global exclusion
    # k larger than the index: missing slots are -1 / +inf
    small = tflat.FlatIndex(d, "L2", device="cpu")
    small.add(x[:3], labels[:3], paths[:3])
    sd, si = small.search(q[:2], 5)
    assert (si[:, 3:] == -1).all() and np.isinf(sd[:, 3:]).all()
    with pytest.raises(NotImplementedError):
        tflat.FlatIndex(d, "IVF", device="cpu")


def test_bf16_scan_product_has_f32_output(rng):
    """torch's bf16 @ bf16 rounds its output to bf16, which would break the
    certificate's f32 margin; the scan's product keeps f32 (on the CPU by
    upcasting: bf16 products are exact in f32)."""
    a = torch.as_tensor(rng.standard_normal((8, 512)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((16, 512)).astype(np.float32))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    assert (a @ b.t()).dtype == torch.bfloat16
    got = tflat.bf16_mm_f32(a, b)
    assert got.dtype == torch.float32
    want = a.double() @ b.double().t()
    assert float((got.double() - want).abs().max()) < 1e-4
    assert float(((a @ b.t()).double() - want).abs().max()) > 1e-3


def test_top_k_stable_puts_lower_index_first():
    """jax.lax.top_k's tie order: among equal values, lower index first."""
    x = torch.tensor([[1.0, 3.0, 3.0, -np.inf, 3.0, 2.0, 2.0]])
    vals, idx = tflat.top_k_stable(x, 5)
    assert idx.tolist() == [[1, 2, 4, 5, 6]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == np.asarray(ji).tolist()


def test_precision_flags():
    """TF32 off for matmuls and cuDNN convolutions, f32 reduction for bf16
    products: what the encoder's f32 parity and the certificate assume."""
    from radad_tpu_torch.utils.device import set_precision_flags

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    try:
        torch.backends.cudnn.allow_tf32 = True
        set_precision_flags()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert not (torch.backends.cuda.matmul
                    .allow_bf16_reduced_precision_reduction)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
         ) = flags
