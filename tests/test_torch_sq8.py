"""The port's SQ8 index (radad_tpu_torch/index/quantized.py) against the JAX
package's, on the CPU: the host codecs bit for bit, the int8 scan, the
accelerated search route against JAX's ``_sq8_search`` with ``codes3`` and
an interpret-mode ``exact_dot``, the over-fetch route against JAX's CPU
search, adds, reconstruction, index files both ways, and the pipeline, CLI
and server with ``--index_type SQ8``."""

import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.index import quantized as jq
from radad_tpu.ops import rerank as jrerank
from radad_tpu_torch.data.manifest import file_id
from radad_tpu_torch.index import quantized as tq

D, N, B, K = 256, 600, 8, 5
VARIANTS = {"plain": {}, "residual": dict(residual_nlist=16),
            "refine": dict(refine_bits=4)}


def _data(seed=0):
    """N clustered rows (12 clusters), B queries near rows 0 .. B-1,
    labels and paths."""
    rng = np.random.default_rng(seed)
    centres = 3.0 * rng.standard_normal((12, D))
    x = (centres[rng.integers(0, 12, N)]
         + rng.standard_normal((N, D))).astype(np.float32)
    q = (x[:B] + 0.05 * rng.standard_normal((B, D))).astype(np.float32)
    labels = (rng.random(N) > 0.5).astype(np.float32)
    paths = [f"clip_{i:04d}.wav" for i in range(N)]
    return x, q, labels, paths


def _jax_index(metric="L2", variant="plain", **kw):
    x, q, labels, paths = _data()
    idx = jq.QuantizedIndex(D, metric, **VARIANTS[variant], **kw)
    idx.add(x, labels, paths)
    return idx, q


def _port_arrays(jidx):
    """The JAX index's device arrays as CPU tensors, by the port's
    ``_sq8_search`` keyword names."""
    out = {}
    for name in ("codes", "scales", "norm_sq", "labels", "ids", "centroids",
                 "cells", "codes2", "scales2"):
        arr = getattr(jidx, name)
        out[name] = None if arr is None else torch.as_tensor(np.array(arr))
    return out


def _f64_scores(q, rows, metric):
    q, rows = q.astype(np.float64), rows.astype(np.float64)
    if metric == "L2":
        return ((rows - q) ** 2).sum(-1)
    return rows @ q


def _rounding(q, rows, metric):
    """The f32 rounding that a score of ``q`` against ``rows`` can carry
    from its sums over D terms in any order (Higham and Mary's
    probabilistic form, sqrt(D) 2^-24 sum |term|): for L2 the expanded
    |q|^2 - 2 q.x + |x|^2 over |q|^2 + |x|^2 + 2 sum |q_d x_d|, the largest
    over ``rows``."""
    q, rows = np.abs(q.astype(np.float64)), np.abs(rows.astype(np.float64))
    terms = rows @ q
    if metric == "L2":
        terms = q @ q + (rows ** 2).sum(-1) + 2.0 * terms
    return np.sqrt(q.shape[-1]) * 2.0 ** -24 * terms.max()


def _hold(got_d, got_i, want_d, want_i, q, recon, metric):
    """Distances within 1e-4 relative (``tests/test_index.py``'s SQ8
    tolerance) plus twice their f32 rounding (``_rounding``: a distance
    near 0 is the difference of terms of ~|q|^2); ids equal, except that
    neighbors whose f64 scores over the dequantized rows (``recon``) tie
    within that rounding may swap: there the f64 scores of the two id lists
    agree rank by rank. Returns the rows with swaps."""
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    np.testing.assert_array_equal(got_i < 0, want_i < 0)
    swapped = 0
    for row in range(len(got_i)):
        ok = want_i[row] >= 0
        g, w = recon(got_i[row][ok]), recon(want_i[row][ok])
        tol = 2.0 * _rounding(q[row], np.concatenate([g, w]), metric)
        err = np.abs(got_d[row][ok] - want_d[row][ok])
        assert (err <= 1e-4 * np.abs(want_d[row][ok]) + tol).all(), (
            row, got_d[row], want_d[row], tol)
        if (got_i[row] == want_i[row]).all():
            continue
        gs = np.sort(_f64_scores(q[row], g, metric))
        ws = np.sort(_f64_scores(q[row], w, metric))
        assert (np.abs(gs - ws) <= tol).all(), (row, gs, ws, tol)
        swapped += 1
    return swapped


# ------------------------------------------------------------------ codecs
@pytest.mark.parametrize("case", ["gaussian", "wide", "zero_row"])
def test_codecs_match_jax_bit_for_bit(case):
    """quantize_rows, quantize_refinement, the nibble decode and
    unpack_refinement give the JAX package's bytes and floats."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    if case == "wide":
        x *= np.exp(rng.uniform(-8, 8, (64, 1))).astype(np.float32)
    if case == "zero_row":
        x[5] = 0.0
        x[9, ::2] = 0.0
    codes, scales = tq.quantize_rows(x)
    jc, js = jq.quantize_rows(x)
    np.testing.assert_array_equal(codes, jc)
    np.testing.assert_array_equal(scales, js)
    assert codes.dtype == np.int8 and scales.dtype == np.float32
    r2 = x - codes.astype(np.float32) * scales[:, None]
    packed, s2 = tq.quantize_refinement(r2)
    jp, js2 = jq.quantize_refinement(r2)
    np.testing.assert_array_equal(packed, jp)
    np.testing.assert_array_equal(s2, js2)
    np.testing.assert_array_equal(tq._unpack_nibbles_np(packed),
                                  jq._unpack_nibbles_np(packed))
    got = tq.unpack_refinement(torch.as_tensor(packed), torch.as_tensor(s2))
    want = np.asarray(jq.unpack_refinement(jnp.asarray(packed),
                                           jnp.asarray(s2)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(tq._unpack_nibbles_np(packed)).max() <= 7


@pytest.mark.parametrize("b", [1, 8, 33])
def test_int8_scan_equals_int64_product(b):
    """Exact int32 sums, including rows of ±127 at the largest |sum|."""
    g = torch.Generator().manual_seed(b)
    q8 = torch.randint(-127, 128, (b, 5376), generator=g, dtype=torch.int8)
    codes = torch.randint(-127, 128, (1024, 5376), generator=g,
                          dtype=torch.int8)
    q8[0] = 127
    codes[3] = 127
    codes[4] = -127
    got = tq.int8_scan(q8, codes)
    assert got.dtype == torch.int32 and got.shape == (b, 1024)
    assert torch.equal(got.long(), q8.long() @ codes.long().t())
    assert int(got[0, 3]) == 127 * 127 * 5376


# ------------------------------------------------------- the search routes
@pytest.fixture
def interpret_exact_dot(monkeypatch):
    orig = jrerank.exact_dot
    monkeypatch.setattr(jrerank, "exact_dot",
                        lambda q3, x3, ii: orig(q3, x3, ii, interpret=True))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("exclude_mode", ["batch", "self"])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_accel_route_matches_jax(metric, exclude_mode, variant,
                                 interpret_exact_dot):
    """The accelerated route (tile select + exact_dot on int8 rows + the
    centroid and int4 terms) against JAX's, which takes it only with a
    ``codes3`` layout: here ``codes.reshape(cap, D / 128, 128)``, its
    ``exact_dot`` in interpret mode. The queries' own rows are excluded
    (each its own, or the batch's union). JAX's ``_sq8_search`` gets the
    queries as the port's ``retrieve_on_device_sq8`` makes them (COSINE:
    each row normalized; JAX's own retrieve divides the batch by
    ``jnp.linalg.norm(q, -1)``, a matrix norm, ROADMAP Queue 3)."""
    jidx, q = _jax_index(metric, variant)
    a = _port_arrays(jidx)
    cap = a["codes"].shape[0]
    ex = a["ids"][:B].clone()
    qn = q if metric != "COSINE" else q / np.linalg.norm(q, axis=-1,
                                                         keepdims=True)
    codes3 = jnp.reshape(jidx.codes, (cap, D // 128, 128))
    wd, wi, wn = jq._sq8_search(
        jnp.asarray(qn), jidx.codes, jidx.scales, jidx.norm_sq, jidx.ids,
        jnp.asarray(ex.numpy()), K, metric=metric, n_valid=N, codes3=codes3,
        exclude_mode=exclude_mode, centroids=jidx.centroids,
        cells=jidx.cells, codes2=jidx.codes2, scales2=jidx.scales2)
    wd, wi, wn = np.asarray(wd), np.asarray(wi), np.asarray(wn)
    wl = np.where(wi >= 0, np.asarray(jidx.labels)[np.maximum(wi, 0)], 0.0)
    got = tq.retrieve_on_device_sq8(
        torch.as_tensor(q), a["codes"], a["scales"], a["norm_sq"],
        a["labels"], a["ids"], ex, k=K, metric=metric, n_valid=N,
        accel=True, exclude_mode=exclude_mode, centroids=a["centroids"],
        cells=a["cells"], codes2=a["codes2"], scales2=a["scales2"])
    gn, gl, gd, gi = (t.numpy() for t in got)
    swapped = _hold(gd, gi, wd, wi, qn, jidx.reconstruct_batch, metric)
    if not swapped:
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gn, wn, rtol=1e-6, atol=1e-6)
    own = a["ids"].numpy()[gi]
    if exclude_mode == "self":
        assert not (own == ex.numpy()[:, None]).any()
    else:
        assert not np.isin(own, ex.numpy()).any()
    assert gi.dtype == np.int32 and (gi >= 0).all()


@pytest.mark.parametrize("depth", [None, 3, 64])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_overfetch_route_matches_jax(variant, depth):
    """``build_accel=False`` (top-k over-fetch, gather, dequantize, f32
    bmm) against JAX's default search on the CPU over the same index files,
    with the batch's rows excluded; a depth below k floors at k."""
    import tempfile

    jidx, q = _jax_index("L2", variant, rerank_depth=depth)
    with tempfile.TemporaryDirectory() as tmp:
        jidx.save(tmp)
        tidx = tq.QuantizedIndex.load(tmp, build_accel=False, device="cpu")
    tidx.rerank_depth = depth
    assert tidx.route == "sq8_overfetch"
    ex = np.asarray(jidx.ids)[:B]
    wd, wi = jidx.search(q, K, exclude_ids=ex)
    gd, gi = tidx.search(q, K, exclude_ids=ex)
    _hold(gd, gi, wd, wi, q, jidx.reconstruct_batch, "L2")
    assert not np.isin(gi, np.arange(B)).any()
    assert tidx.searches == 1 and tidx.fallbacks == 0


# ------------------------------------------------------------- the index
@pytest.mark.parametrize("variant", ["plain", "refine"])
def test_build_matches_jax_and_incremental_equals_one_shot(variant):
    """The port's add stores the JAX package's bytes; three adds store what
    one add stores (codes, scales, norms, int4 level, labels, ids), with
    the capacity growing in 1,024-row quanta."""
    x, _, labels, paths = _data()
    jidx = jq.QuantizedIndex(D, "L2", **VARIANTS[variant])
    jidx.add(x, labels, paths)
    one = tq.QuantizedIndex(D, "L2", device="cpu", **VARIANTS[variant])
    one.add(torch.as_tensor(x), labels, paths)
    inc = tq.QuantizedIndex(D, "L2", device="cpu", **VARIANTS[variant])
    for lo, hi in ((0, 100), (100, 101), (101, N)):
        inc.add(x[lo:hi], labels[lo:hi], paths[lo:hi])
    names = ["codes", "scales", "norm_sq", "labels", "ids"]
    if variant == "refine":
        names += ["codes2", "scales2"]
    for name in names:
        want = np.asarray(getattr(jidx, name))
        np.testing.assert_array_equal(getattr(one, name).numpy(), want,
                                      err_msg=name)
        np.testing.assert_array_equal(getattr(inc, name)[:N].numpy(),
                                      want[:N], err_msg=name)
    assert one.codes.shape[0] == 1024 and inc.codes.shape[0] == 1024
    assert (inc.ids[N:] == -1).all() and inc.paths == paths
    grow = tq.QuantizedIndex(D, "L2", device="cpu", capacity=3000)
    grow.add(x[:10], labels[:10], paths[:10])
    grow.add(np.tile(x, (2, 1)), np.tile(labels, 2), paths * 2)
    assert grow.codes.shape[0] == 3072 and grow.ntotal == 10 + 2 * N


def test_residual_add_freezes_the_codebook():
    """Residual mode trains on the first add; a later add assigns against
    the same centroids (the JAX package's _assign_cells) and leaves the
    stored rows unchanged."""
    x, _, labels, paths = _data()
    idx = tq.QuantizedIndex(D, "L2", residual_nlist=16, device="cpu")
    idx.add(x[:400], labels[:400], paths[:400])
    cents = idx.centroids.clone()
    before = idx.codes[:400].clone()
    idx.add(x[400:], labels[400:], paths[400:])
    assert torch.equal(idx.centroids, cents)
    assert torch.equal(idx.codes[:400], before)
    from radad_tpu.index.flat import _assign_cells as jassign

    want = np.asarray(jassign(jnp.asarray(x), jnp.asarray(cents.numpy())))
    np.testing.assert_array_equal(idx.cells[:N].numpy(), want)
    resid = x - cents.numpy()[want]
    codes, scales = tq.quantize_rows(resid)
    np.testing.assert_array_equal(idx.codes[:N].numpy(), codes)
    np.testing.assert_array_equal(idx.scales[:N].numpy(), scales)
    assert (idx.cells[N:] == -1).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_reconstruct_and_retrieve_match_jax(variant, tmp_path):
    """reconstruct_batch (index -1 a zero row) and retrieve_on_device_sq8's
    over-fetch route (neighbors, labels, distances, ids) equal JAX's on
    the same files."""
    jidx, q = _jax_index("L2", variant)
    jidx.save(str(tmp_path))
    tidx = tq.QuantizedIndex.load(str(tmp_path), device="cpu")
    rows = np.array([[0, 5, -1], [N - 1, 17, 300]])
    np.testing.assert_array_equal(tidx.reconstruct_batch(rows),
                                  jidx.reconstruct_batch(rows))
    a = _port_arrays(jidx)
    ex = a["ids"][:B].clone()
    want = jq.retrieve_on_device_sq8(
        jnp.asarray(q), jidx.codes, jidx.scales, jidx.norm_sq, jidx.labels,
        jidx.ids, jnp.asarray(ex.numpy()), k=K, metric="L2", n_valid=N,
        exclude_mode="self", centroids=jidx.centroids, cells=jidx.cells,
        codes2=jidx.codes2, scales2=jidx.scales2)
    got = tq.retrieve_on_device_sq8(
        torch.as_tensor(q), tidx.codes, tidx.scales, tidx.norm_sq,
        tidx.labels, tidx.ids, ex, k=K, metric="L2", n_valid=N, accel=False,
        exclude_mode="self", **tidx._arrays())
    wn, wl, wd, wi = (np.asarray(t) for t in want)
    gn, gl, gd, gi = (t.numpy() for t in got)
    assert not _hold(gd, gi, wd, wi, q, jidx.reconstruct_batch, "L2")
    np.testing.assert_array_equal(gl, wl)
    # XLA contracts JAX's s * codes + c into one FMA: an ulp apart
    np.testing.assert_allclose(gn, wn, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_index_files_cross_both_ways(variant, tmp_path):
    """JAX saves and the port loads; the port saves and JAX loads: the same
    arrays and the same search results either way."""
    jidx, q = _jax_index("L2", variant)
    jidx.save(str(tmp_path / "jax"))
    tidx = tq.QuantizedIndex.load(str(tmp_path / "jax"), build_accel=False,
                                  device="cpu")
    tidx.save(str(tmp_path / "port"))
    back = jq.QuantizedIndex.load(str(tmp_path / "port"))
    for name in ("codes", "scales", "norm_sq", "labels", "ids", "cells",
                 "codes2", "scales2", "centroids"):
        want = getattr(jidx, name)
        if want is None:
            assert getattr(back, name) is None and getattr(tidx,
                                                           name) is None
            continue
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(want), err_msg=name)
        np.testing.assert_array_equal(getattr(tidx, name).numpy(),
                                      np.asarray(want), err_msg=name)
    assert back.paths == tidx.paths == jidx.paths
    assert (back.residual_nlist, back.refine_bits) == (
        jidx.residual_nlist, jidx.refine_bits)
    wd, wi = jidx.search(q, K)
    gd, gi = back.search(q, K)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    gd, gi = tidx.search(q, K)
    assert not _hold(gd, gi, wd, wi, q, jidx.reconstruct_batch, "L2")
    with open(tmp_path / "port" / "sq8_meta.json") as f:
        meta = json.load(f)
    assert meta["n"] == N and meta["dimension"] == D


def test_flat_overfetch_reconstruct_labels_match_jax(rng):
    """FlatIndex.search_overfetch (the reference's over-fetch-and-filter
    retrieval), reconstruct_batch and labels_for equal JAX's, and the
    over-fetch agrees with the masked search."""
    from radad_tpu.index.flat import FlatIndex as JFlat
    from radad_tpu_torch.index.flat import FlatIndex

    x, _, labels, paths = _data()
    x = x[:120]
    jidx, tidx = JFlat(D, "L2"), FlatIndex(D, "L2", device="cpu")
    for idx in (jidx, tidx):
        idx.add(x, labels[:120], paths[:120])
    q, names = x[:12], paths[:12]
    want = jidx.search_overfetch(q, K, exclude_basenames=names)
    got = tidx.search_overfetch(q, K, exclude_basenames=names)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    d_mask, i_mask = tidx.search(q, K, exclude_ids=[file_id(p)
                                                     for p in names])
    np.testing.assert_array_equal(i_mask, got[1])
    np.testing.assert_array_equal(tidx.search_overfetch(q, K)[1],
                                  jidx.search_overfetch(q, K)[1])
    rows = np.array([[3, -1, 119], [0, 7, 7]])
    np.testing.assert_array_equal(tidx.reconstruct_batch(rows),
                                  jidx.reconstruct_batch(rows))
    np.testing.assert_array_equal(tidx.labels_for(rows),
                                  jidx.labels_for(rows))


# ------------------------------------------------------------ the pipeline
def _pipe_kw(root, vdb=None, **over):
    kw = dict(data_root=root, vector_db_path=vdb or os.path.join(root, "vdb"),
              db_batch_size=8, batch_size=8, eval_batch_size=8,
              vector_db_index_type="SQ8", projection_dropout=0.0,
              detection_dropout=0.0)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def sq8_pipes(tmp_path_factory, synthetic_dataset):
    """A JAX SQ8 pipeline with its DB built and saved; the port's pipeline
    on the same encoder and fusion weights that built its own DB
    (``own``), and one that loaded the JAX package's DB (``loaded``)."""
    from radad_tpu.config import Config as JConfig
    from radad_tpu.data.manifest import load_manifests
    from radad_tpu.train.pipeline import DetectionPipeline as JPipe
    from radad_tpu_torch.config import Config as TConfig
    from radad_tpu_torch.models.convert import fusion_from_flax
    from radad_tpu_torch.train.pipeline import DetectionPipeline as TPipe

    from test_torch_train import _encoders, _np

    jenc, tenc = _encoders()
    splits = load_manifests(synthetic_dataset)
    jroot = str(tmp_path_factory.mktemp("jax_sq8"))
    troot = str(tmp_path_factory.mktemp("torch_sq8"))
    jpipe = JPipe(JConfig().replace(**_pipe_kw(jroot)), encoder=jenc)
    jpipe._ensure_model_state()
    jpipe.build_vector_database(splits["train"])
    pipes = {}
    for name, vdb in (("own", None), ("loaded", jpipe.config.vector_db_path)):
        pipe = TPipe(TConfig().replace(**_pipe_kw(os.path.join(troot, name),
                                                  vdb)),
                     encoder=tenc, device="cpu")
        fusion_from_flax(pipe.model, _np(jpipe.variables))
        pipes[name] = pipe
    pipes["own"].build_vector_database(splits["train"], save=False)
    assert pipes["loaded"].load_vector_database()
    return jpipe, pipes, splits


def test_pipeline_build_db_matches_jax(sq8_pipes):
    """The port's SQ8 DB build: the JAX DB's rows, ids and labels; codes
    within one step of JAX's (the embeddings differ by f32 summation
    order), scales within 1e-4 relative."""
    from radad_tpu_torch.index.quantized import QuantizedIndex

    jpipe, pipes, _ = sq8_pipes
    j, t = jpipe.index, pipes["own"].index
    assert isinstance(t, QuantizedIndex) and t.route == "sq8"
    n = j.ntotal
    assert t.ntotal == n and t.paths == j.paths
    np.testing.assert_array_equal(t.ids[:n].numpy(), np.asarray(j.ids)[:n])
    np.testing.assert_array_equal(t.labels[:n].numpy(),
                                  np.asarray(j.labels)[:n])
    diff = np.abs(t.codes[:n].numpy().astype(int)
                  - np.asarray(j.codes)[:n].astype(int))
    assert diff.max() <= 1 and diff.mean() < 0.05
    np.testing.assert_allclose(t.scales[:n].numpy(), np.asarray(j.scales)[:n],
                               rtol=1e-4)
    loaded = pipes["loaded"].index
    np.testing.assert_array_equal(loaded.codes[:n].numpy(),
                                  np.asarray(j.codes)[:n])


@pytest.mark.parametrize("split", ["val", "train"])
def test_pipeline_predict_batch_matches_jax(sq8_pipes, split):
    """predict_batch on the JAX package's DB: identical neighbor files,
    logits within 1e-4, distances within 1e-4 (train clips exercise the
    per-row self exclusion); predict on one clip too."""
    jpipe, pipes, splits = sq8_pipes
    tpipe = pipes["loaded"]
    paths = list(splits[split].paths[:5])
    before = tpipe.index.searches
    for path, j, t in zip(paths, jpipe.predict_batch(paths),
                          tpipe.predict_batch(paths)):
        assert t["retrieved_files"] == j["retrieved_files"], path
        assert abs(t["logit"] - j["logit"]) < 1e-4, path
        np.testing.assert_allclose(
            [r["distance"] for r in t["retrieved"]],
            [r["distance"] for r in j["retrieved"]], rtol=1e-4, atol=1e-3)
        assert os.path.basename(path) not in t["retrieved_files"]
    j, t = jpipe.predict(paths[0]), tpipe.predict(paths[0])
    assert t["retrieved_files"] == j["retrieved_files"]
    assert abs(t["logit"] - j["logit"]) < 1e-4
    assert tpipe.index.searches > before and tpipe.index.fallbacks == 0


def test_pipeline_train_steps_match_jax(sq8_pipes):
    """Two train steps (B = 8, batch exclusion, pad rows, BatchNorm,
    dropout 0) on the JAX package's DB, each from JAX's state: the
    retrieved neighbors equal JAX's, loss and group gradient norms within
    1e-5, gradients, Adam state and parameters by test_torch_train's
    _hold_step."""
    jpipe, pipes, splits = sq8_pipes
    hold_two_train_steps(jpipe, pipes["loaded"], splits["train"], "L2")


def hold_two_train_steps(jpipe, tpipe, train_m, metric):
    """Two train steps of ``tpipe`` (the port) against ``jpipe`` (JAX, the
    same DB, encoder and fusion weights), each from JAX's state: the
    neighbors the port's step fetches equal JAX's retrieval (``metric`` as
    JAX's ``_retrieve`` takes it), loss and group gradient norms within
    1e-5, gradients, Adam state and parameters by _hold_step."""
    from radad_tpu.train import optim as joptim
    from radad_tpu_torch.models.convert import (adam_state_from_optax,
                                                fusion_from_flax)
    from radad_tpu_torch.train.pipeline import new_accumulators

    from test_torch_train import _hold_step, _np

    pw = train_m.pos_weight()
    jtrain, _ = jpipe._steps()
    index_args = jpipe._index_args()
    jvars = jax.tree_util.tree_map(jnp.array, jpipe.variables)
    jstate = jax.tree_util.tree_map(jnp.array, jpipe.opt_state)
    jacc = {k: jnp.float32(0.0) for k in (
        "loss_sum", "correct", "count", "nnz_sum", "gn_proj_sum",
        "gn_fuse_sum", "gn_det_sum", "batches")}
    jmodel = jpipe.model

    def jloss(params, variables, neighbors, tpp, labels, valid):
        logits, _ = jmodel.apply({**variables, "params": params}, neighbors,
                                 tpp, deterministic=False,
                                 use_running_average=False,
                                 mutable=["batch_stats"])
        return joptim.pos_weighted_bce(logits, labels, pw, valid)

    jgrad = jax.jit(jax.grad(jloss))
    steps = tpipe._steps()
    batches = list(jpipe._query_batches(train_m, 8, shuffle=True, seed=0))
    for step, (tpp, labels, ids, valid) in enumerate(batches[:2]):
        fusion_from_flax(tpipe.model, _np(jvars))
        tpipe.opt.load_state_dict(adam_state_from_optax(_np(jstate),
                                                        tpipe.model))
        jneigh = jpipe._retrieve(index_args, tpp, ids, k=5, metric=metric,
                                 n_valid=jpipe.index.ntotal)[0]
        t = [torch.as_tensor(np.array(a)) for a in (tpp, labels, ids, valid)]
        neighbors, _ = steps.fetch(t[0], t[2])
        np.testing.assert_allclose(neighbors.numpy(), np.asarray(jneigh),
                                   rtol=1e-6, atol=1e-6)
        jgrads = jgrad(jvars["params"], jvars, jneigh, tpp, labels, valid)
        jvars, jstate, jacc, jbm = jtrain(
            jvars, jstate, jacc, index_args, tpp, labels, ids, valid, pw,
            jax.random.PRNGKey(step))
        loss, logits, grads = steps.forward_backward(neighbors, t[0], t[1],
                                                     t[3], pw)
        tbm = steps.apply(new_accumulators("cpu"), neighbors, t[1], t[3],
                          loss, logits, grads)
        assert abs(float(tbm["loss"]) - float(jbm["loss"])) <= 1e-5 * abs(
            float(jbm["loss"])), step
        for key in ("gn_proj", "gn_fuse", "gn_det"):
            assert abs(float(tbm[key]) - float(jbm[key])) <= 1e-5 * float(
                jbm[key]), (step, key)
        _hold_step(tpipe.model, tpipe.opt, grads, jvars["params"], jgrads,
                   jstate, step)


def test_cli_and_server_run_sq8(synthetic_dataset, tmp_path, rng):
    """The CLI with --index_type SQ8 --sq8_residual_nlist 4
    --sq8_refine_bits 4 on the CPU: train (builds and saves the DB),
    evaluate, predict and build_db; the JAX package loads the saved DB and
    searches it as the port does; the server's --index_type SQ8 serves it
    (/api/dbinfo, /api/predict)."""
    from radad_tpu_torch import cli
    from radad_tpu_torch.models.wav2vec2 import Wav2Vec2Config as TW
    from radad_tpu_torch.serve import app

    from test_torch_encoder import TINY, _fake_hf_state_dict

    root = str(tmp_path / "run")
    ckdir = os.path.join(root, "weights", "org--tiny")
    os.makedirs(ckdir)
    sd = _fake_hf_state_dict(rng, TW(**TINY))
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               os.path.join(ckdir, "pytorch_model.bin"))
    with open(os.path.join(ckdir, "config.json"), "w") as f:
        json.dump({k: list(v) if isinstance(v, tuple) else v
                   for k, v in TINY.items()}, f)
    common = ["--device", "cpu", "--data_path", synthetic_dataset,
              "--data_root", root, "--model_name", "org/tiny",
              "--batch_size", "8", "--eval_batch_size", "8",
              "--db_batch_size", "8", "--epochs", "1", "--index_type",
              "SQ8", "--sq8_residual_nlist", "4", "--sq8_refine_bits", "4"]
    assert cli.main(["--mode", "train"] + common) == 0
    vdb = os.path.join(root, "vector_db")
    with open(os.path.join(vdb, "sq8_meta.json")) as f:
        meta = json.load(f)
    assert (meta["residual_nlist"], meta["refine_bits"]) == (4, 4)
    assert cli.main(["--mode", "evaluate"] + common) == 0
    clip = os.path.join(synthetic_dataset, "clip_000.wav")
    assert cli.main(["--mode", "predict", "--audio_path", clip]
                    + common) == 0
    assert cli.main(["--mode", "build_db"] + common) == 0

    jidx = jq.QuantizedIndex.load(vdb)
    tidx = tq.QuantizedIndex.load(vdb, build_accel=False, device="cpu")
    q = np.asarray(jidx.reconstruct_batch(np.arange(4))) + 0.01
    wd, wi = jidx.search(q, K)
    gd, gi = tidx.search(q, K)
    _hold(gd, gi, wd, wi, q, jidx.reconstruct_batch, "L2")

    args = app.build_parser().parse_args(
        ["--data_path", synthetic_dataset, "--data_root", root, "--device",
         "cpu", "--index_type", "sq8", "--model_name", "org/tiny"])
    cfg = app.config_from_args(args)
    assert cfg.vector_db_index_type == "SQ8"
    httpd = app.serve(cfg, host="127.0.0.1", port=0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(base + "/api/dbinfo", timeout=60) as r:
            info = json.loads(r.read())
        assert info["ntotal"] == jidx.ntotal and info["index_file_exists"]
        assert info["metadata_file_exists"]
        with open(clip, "rb") as f:
            wav = f.read()
        boundary = "radadtestboundary"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f"name=\"file\"; filename=\"up.wav\"\r\nContent-Type: "
                f"audio/wav\r\n\r\n").encode() + wav + \
            f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            base + "/api/predict", data=body, method="POST",
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        assert out["ok"] and len(out["neighbors"]) == 5
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def test_pipeline_sq8_device_rule_retry_and_depth(sq8_pipes, tmp_path):
    """Without a GPU the SQ8 index and pipeline raise unless given
    device='cpu'; a predict_batch row whose neighbors were all excluded
    retries unexcluded on its own; load_vector_database takes
    rerank_depth from the config."""
    from radad_tpu_torch.index.quantized import QuantizedIndex
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    jpipe, pipes, splits = sq8_pipes
    tpipe = pipes["own"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            QuantizedIndex(16)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DetectionPipeline(tpipe.config, encoder=tpipe.encoder)
    src, other = splits["train"].paths[0], splits["train"].paths[1]
    emb = tpipe.get_embeddings(splits["train"])
    one = QuantizedIndex(tpipe.tpp_dim, "L2", device="cpu")
    one.add(emb[:1], [1.0], [src], ids=[file_id(src)])
    old, tpipe.index = tpipe.index, one
    try:
        outs = tpipe.predict_batch([src, other])
        for out in outs:
            assert out["retrieved_files"][0] == os.path.basename(src)
            assert np.isfinite(out["logit"])
        assert outs[0]["retrieved_files"][1:] == [""] * 4
    finally:
        tpipe.index = old
    deep = DetectionPipeline(
        tpipe.config.replace(vector_db_path=jpipe.config.vector_db_path,
                             sq8_rerank_depth=7),
        encoder=tpipe.encoder, device="cpu")
    assert deep.load_vector_database()
    assert deep.index.rerank_depth == 7 and deep.index.ntotal == \
        jpipe.index.ntotal
