"""``FlatIndex(build_accel=False)`` in the port against the JAX package's, on
the CPU: no scan arrays, the exact f32 scan on every search (counted as a
search, never as a fallback), the JAX index's ids and distances with and
without batch exclusion, both packages' files through ``save`` →
``load(build_accel=False)``, and the default index still on the certified
route."""

import numpy as np
import pytest
import torch

from radad_tpu.index import flat as jflat
from radad_tpu_torch.index import flat as tflat

N, D, B, K = 1000, 256, 12, 5


def _rows(rng, metric="L2"):
    """Seeded rows, labels, paths, ids (331 distinct: rows share ids) and
    queries."""
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    labels = (rng.random(N) > 0.5).astype(np.float32).tolist()
    paths = [f"/data/clip_{i:04d}.wav" for i in range(N)]
    ids = [int(i % 331) for i in range(N)]
    return x, q, labels, paths, ids


def _both(rng, metric="L2", **kw):
    """The same rows in a JAX and a port index, both ``build_accel=False``
    (``kw`` to both)."""
    x, q, labels, paths, ids = _rows(rng, metric)
    jidx = jflat.FlatIndex(D, metric, build_accel=False, **kw)
    jidx.add(x, labels, paths, ids=ids)
    tidx = tflat.FlatIndex(D, metric, build_accel=False, device="cpu", **kw)
    tidx.add(x, labels, paths, ids=ids)
    return jidx, tidx, q


def _same_search(jidx, tidx, q, excl):
    jd, ji = jidx.search(q, K, exclude_ids=excl)
    td, ti = tidx.search(q, K, exclude_ids=excl)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-3)
    return ti


@pytest.mark.parametrize("use_float16", [False, True])
def test_no_scan_arrays(use_float16, rng):
    """No scan copy and no residual, also where bf16 storage would make the
    stored rows the scan copy; capacity growth keeps it so."""
    x, _, labels, paths, ids = _rows(rng)
    idx = tflat.FlatIndex(D, "L2", build_accel=False,
                          use_float16=use_float16, add_batch_size=300,
                          device="cpu")
    idx.add(x[:600], labels[:600], paths[:600], ids=ids[:600])
    idx.add(x[600:], labels[600:], paths[600:], ids=ids[600:])
    assert idx.ntotal == N and idx.vectors.shape[0] == 1024
    assert idx.scan_bf16 is None and idx.resid_bf16 is None
    assert idx.route == "full_scan"
    assert tflat.FlatIndex(D, build_accel=False, use_pallas=True,
                           device="cpu").route == "flat_topk"


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("exclusion", [None, "batch"])
def test_full_scan_matches_jax(metric, exclusion, rng):
    """ids equal to JAX's ``FlatIndex(build_accel=False)`` search, distances
    within f32 summation order, each search counted and none a
    fallback; batch exclusion drops every row of the batch's ids."""
    jidx, tidx, q = _both(rng, metric)
    excl = None if exclusion is None else np.arange(B, dtype=np.int32) * 7
    ti = _same_search(jidx, tidx, q, excl)
    if excl is not None:
        assert not np.isin(np.asarray(tidx.ids)[ti], excl).any()
    assert tidx.searches == 1 and tidx.fallbacks == 0


def test_full_scan_matches_jax_bf16_storage(rng):
    """bf16 storage: the port scans the stored rows in f32; JAX scans them
    in bf16 and re-ranks 32 candidates exactly. On these rows (no near-tie
    within bf16 rounding) both give the same ids."""
    jidx, tidx, q = _both(rng, use_float16=True)
    _same_search(jidx, tidx, q, np.arange(B, dtype=np.int32) * 7)
    assert tidx.searches == 1 and tidx.fallbacks == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_without_accel(writer, rng, tmp_path):
    """A saved index (either package's files) loads with
    ``build_accel=False`` in both packages: no scan arrays in the port, the
    same search as the index that wrote it."""
    jidx, tidx, q = _both(rng)
    (jidx if writer == "jax" else tidx).save(str(tmp_path))
    tload = tflat.FlatIndex.load(str(tmp_path), build_accel=False,
                                 device="cpu")
    jload = jflat.FlatIndex.load(str(tmp_path), build_accel=False)
    assert tload.scan_bf16 is None and tload.resid_bf16 is None
    assert tload.build_accel is False and tload.paths == tidx.paths
    excl = np.arange(B, dtype=np.int32) * 7
    ji = _same_search(jload, tload, q, excl)
    np.testing.assert_array_equal(ji, tidx.search(q, K, exclude_ids=excl)[1])


def test_default_takes_certified_route(rng):
    """Without the argument the index builds its scan arrays and searches
    by the certificate: on these rows it holds (no fallback) and gives the
    full scan's ids; on 101 rows tied within bf16 resolution in one tile
    it fails at k = 20 and counts a fallback, where ``build_accel=False``
    counts none and gives the same ids."""
    x, q, labels, paths, ids = _rows(rng)
    cert = tflat.FlatIndex(D, "L2", device="cpu")
    scan = tflat.FlatIndex(D, "L2", build_accel=False, device="cpu")
    for idx in (cert, scan):
        idx.add(x, labels, paths, ids=ids)
    assert cert.route == "certified" and cert.scan_bf16 is not None
    np.testing.assert_array_equal(cert.search(q, K)[1], scan.search(q, K)[1])
    assert (cert.searches, cert.fallbacks) == (1, 0)

    # near-ties: tests/test_torch_index.py::test_near_tie_fallback_...
    nt = 1024 // 128
    base = q[0] + 0.5 * rng.standard_normal(D).astype(np.float32)
    tied = x.copy()
    for j in range(101):
        u = rng.standard_normal(D).astype(np.float32)
        tied[j * nt] = base + 3e-3 * (101 - j) * u / np.linalg.norm(u)
    cert = tflat.FlatIndex(D, "L2", device="cpu")
    scan = tflat.FlatIndex(D, "L2", build_accel=False, device="cpu")
    for idx in (cert, scan):
        idx.add(tied, labels, paths, ids=list(range(N)))
    got = [idx.search(q, 20)[1] for idx in (cert, scan)]
    np.testing.assert_array_equal(got[0], got[1])
    assert (cert.searches, cert.fallbacks) == (1, 1)
    assert (scan.searches, scan.fallbacks) == (1, 0)


def test_pipeline_passes_build_accel(tmp_path):
    """The port's pipeline makes and loads its index with build_accel=True,
    JAX's value without a mesh (``self.mesh is None``)."""
    from radad_tpu_torch.config import Config
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    seen = []
    orig_init = tflat.FlatIndex.__init__

    def spy(self, *a, **kw):
        seen.append(kw.get("build_accel"))
        orig_init(self, *a, **kw)

    cfg = Config(data_root=str(tmp_path), vector_db_path=str(tmp_path / "db"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tflat.FlatIndex, "__init__", spy)
        pipe = DetectionPipeline(cfg, device="cpu", encoder=_TinyEncoder())
        pipe.index.add(torch.zeros((3, pipe.tpp_dim)), [0.0] * 3,
                       ["a.wav", "b.wav", "c.wav"])
        pipe.index.save(cfg.vector_db_path)
        assert pipe.load_vector_database()
    assert seen == [True, True]
    assert pipe.index.route == "certified"


class _TinyEncoder:
    """The attributes DetectionPipeline reads of an encoder, no weights."""

    feature_dim = 8
    compute_dtype = torch.float32
