"""The port's mesh (radad_tpu_torch/parallel) against the JAX package's on
the CPU: a world of 4 gloo ranks (mesh 2 x 2) under torch.multiprocessing
(spawn), the JAX side on conftest's 8-device virtual CPU mesh cut to the
same shape. Mirrors tests/test_parallel.py case by case: the sharded flat
search (L2, IP, COSINE; batch and self exclusion) and its collectives, SQ8
plain and residual, IVF masked and gather-probed (with the over-budget
scan) and the chunk tables; the train step and the tensor-parallel
encoder are tests/test_torch_parallel_step.py.

The world runs all of its cases in one spawn (a module fixture) and
returns numpy results, with a 60 s collective timeout and a join deadline
after which its ranks are killed. The rank-side code is
tests/test_torch_parallel_worlds.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radad_tpu.parallel import make_mesh as jmake_mesh
from radad_tpu_torch.parallel import sharded_index as tsi

from test_torch_parallel_worlds import K, _index_cases, _np_ret, run_world


# ---------------------------------------------------------------- inputs
def _flat_inputs():
    rng = np.random.default_rng(7)
    n, d, b = 333, 48, 16
    return dict(
        vecs=rng.standard_normal((n, d)).astype(np.float32),
        labels=(rng.random(n) > 0.5).astype(np.float32),
        ids=(np.arange(n) % 61).astype(np.int32),
        q=rng.standard_normal((b, d)).astype(np.float32),
        excl=(np.arange(b) % 61).astype(np.int32))


def _clustered(rng, n, d, b, centers=6, scale=4.0):
    c = rng.standard_normal((centers, d)).astype(np.float32) * scale
    return (c[rng.integers(0, centers, n)]
            + rng.standard_normal((n, d)).astype(np.float32),
            c[rng.integers(0, centers, b)]
            + rng.standard_normal((b, d)).astype(np.float32))


def _sq8_inputs():
    """JAX QuantizedIndex arrays (capacity-padded), plain and residual."""
    from radad_tpu.index.quantized import QuantizedIndex

    rng = np.random.default_rng(8)
    n, d, b = 320, 48, 8
    vecs, q = _clustered(rng, n, d, b, centers=8, scale=6.0)
    labels = (rng.random(n) > 0.5).astype(np.float32)
    ids = (np.arange(n) % 61).astype(np.int32)
    out = dict(q=q, excl=(np.arange(b) % 61).astype(np.int32))
    for name, nlist in (("plain", 0), ("residual", 16)):
        ix = QuantizedIndex(d, "L2", residual_nlist=nlist)
        ix.add(vecs, labels, [f"f{i}.wav" for i in range(n)], ids=ids)
        arrs = {a: np.asarray(getattr(ix, a)) for a in
                ("codes", "scales", "norm_sq", "labels", "ids")}
        if nlist:
            arrs["centroids"] = np.asarray(ix.centroids)
            arrs["cells"] = np.asarray(ix.cells)
        out[name] = arrs
    return out


def _ivf_inputs():
    """A JAX IVF FlatIndex over clustered rows (16 cells)."""
    from radad_tpu.index.flat import FlatIndex

    rng = np.random.default_rng(9)
    n, d, b = 500, 32, 8
    vecs, q = _clustered(rng, n, d, b)
    labels = (rng.random(n) > 0.5).astype(np.float32)
    ids = (np.arange(n) % 97).astype(np.int32)
    ivf = FlatIndex(d, "IVF", nlist=16, nprobe=8, use_pallas=False)
    ivf.add(vecs, labels, [f"f{i}.wav" for i in range(n)], ids=ids)
    self_rows = rng.integers(0, n, b)
    return dict(vecs=vecs, labels=labels, ids=ids, q=q,
                excl=(np.arange(b) % 97).astype(np.int32),
                q_self=vecs[self_rows], excl_self=ids[self_rows],
                self_rows=self_rows,
                centroids=np.asarray(ivf.centroids),
                cells=np.asarray(ivf.cells),
                cap_vectors=np.asarray(ivf.vectors),
                cap_ids=np.asarray(ivf.ids),
                cap_labels=np.asarray(ivf.labels))


@pytest.fixture(scope="module")
def index_world(tmp_path_factory):
    payload = dict(flat=_flat_inputs(), sq8=_sq8_inputs(),
                   ivf=_ivf_inputs())
    outs = run_world(_index_cases, 4, tmp_path_factory.mktemp("w4"),
                     payload)
    return payload, outs


@pytest.fixture(scope="module")
def jmesh22():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    return jmake_mesh(data=2, index=2, devices=jax.devices()[:4])


def _same_answers(got, want, rtol=1e-5, what=""):
    """ids equal, distances within ``rtol`` relative, neighbor vectors and
    labels of the returned rows equal (within f32 rounding for rows that
    are reconstructed)."""
    np.testing.assert_array_equal(got["indices"], want["indices"],
                                  err_msg=what)
    np.testing.assert_allclose(got["dists"], want["dists"], rtol=rtol,
                               atol=1e-6, err_msg=what)
    np.testing.assert_array_equal(got["labels"], want["labels"],
                                  err_msg=what)
    np.testing.assert_allclose(got["neighbors"], want["neighbors"],
                               rtol=1e-6, atol=1e-6, err_msg=what)


def test_ranks_sit_at_jax_coordinates(index_world):
    """Rank r sits at (r // index, r % index), the order of JAX's
    np.asarray(devices).reshape(data, index)."""
    _, outs = index_world
    grid = jmake_mesh(data=2, index=2, devices=jax.devices()[:4]).devices
    want = [tuple(int(c) for c in np.argwhere(grid == dev)[0])
            for dev in jax.devices()[:4]]
    assert [o["coords"] for o in outs] == want == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("mode", ["batch", "self"])
def test_sharded_flat_matches_jax_and_one_device(index_world, jmesh22,
                                                 metric, mode):
    """The sharded flat search on a 2 x 2 mesh against JAX's ShardedIndex
    on the same mesh shape and against the one-device exact scan: ids
    equal, distances within 1e-5 relative, neighbor rows and labels equal.
    Every rank of an index group returns the same answers."""
    from radad_tpu.parallel import ShardedIndex

    p, outs = index_world
    f = p["flat"]
    got = outs[0][("flat", metric, mode)]
    for o in outs[1:]:
        for key in got:
            np.testing.assert_array_equal(o[("flat", metric, mode)][key],
                                          got[key])
    jix = ShardedIndex(jmesh22, f["vecs"].shape[1], metric)
    jix.build(f["vecs"], f["labels"], f["ids"])
    want = _np_ret(jix.retrieve(jnp.asarray(f["q"]), jnp.asarray(f["excl"]),
                                K, exclude_mode=mode))
    if metric == "COSINE":
        # JAX divides the queries by jnp.linalg.norm(q, -1, keepdims=True):
        # -1 is ord there, one matrix norm for the batch; the port divides
        # each row by its own norm, so a row's distances differ by a factor
        ratio = want["dists"] / got["dists"]
        np.testing.assert_allclose(ratio, ratio[:, :1] + 0 * ratio,
                                   rtol=1e-5)
        want["dists"] = got["dists"]
    _same_answers(got, want, what=f"{metric} {mode} vs JAX")
    # the one-device exact scan (f64) by id
    x = f["vecs"].astype(np.float64)
    q = f["q"].astype(np.float64)
    if metric == "COSINE":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    s = q @ x.T if metric != "L2" else -((q ** 2).sum(1)[:, None]
                                        - 2 * q @ x.T + (x ** 2).sum(1))
    if mode == "self":
        bad = f["ids"][None, :] == f["excl"][:, None]
    else:
        bad = np.isin(f["ids"], f["excl"])[None, :].repeat(len(q), 0)
    s[bad] = -np.inf
    ref = np.argsort(-s, axis=1, kind="stable")[:, :K]
    np.testing.assert_array_equal(got["indices"], ref)
    ref_d = np.take_along_axis(s, ref, 1)
    np.testing.assert_allclose(got["dists"], -ref_d if metric == "L2"
                               else ref_d, rtol=1e-5, atol=1e-5)


def test_sharded_flat_plain_form(index_world):
    """plain_sharded_retrieve (one process, 2 row blocks) gives the mesh's
    answers."""
    _, outs = index_world
    _same_answers(outs[0][("flat", "L2", "batch")], outs[0]["plain_flat"],
                  rtol=0)


@pytest.mark.parametrize("mode", ["batch", "self"])
def test_sharded_retrieve_collectives(index_world, mode):
    """The merge all-gathers 4 tensors over 'index'; "batch" exclusion adds
    one all-gather over 'data', "self" none; nothing is all-reduced."""
    _, outs = index_world
    want = {"all_gather/index": 4}
    if mode == "batch":
        want["all_gather/data"] = 1
    for o in outs:
        assert o[("calls", "L2", mode)] == want


@pytest.mark.parametrize("name", ["plain", "residual"])
def test_sharded_sq8_matches_jax(index_world, jmesh22, name):
    """SQ8 over 2 shards against JAX's sharded_retrieve_sq8 on the same
    index-axis size (the per-shard pool depends on it) and against the
    plain form: ids equal, distances within 1e-4 relative against JAX (the
    SQ8 tolerance of tests/test_index.py and tests/test_torch_sq8.py: an
    L2 distance is a difference of terms of ~|q|^2) and equal to the plain
    form's, dequantized neighbors within f32 rounding."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radad_tpu.parallel.sharded_index import sharded_retrieve_sq8

    p, outs = index_world
    s, a = p["sq8"], p["sq8"][name]
    row = NamedSharding(jmesh22, P("index", None))
    vec = NamedSharding(jmesh22, P("index"))
    kw = {}
    if "centroids" in a:
        kw = dict(centroids=jax.device_put(a["centroids"],
                                           NamedSharding(jmesh22, P())),
                  cells=jax.device_put(a["cells"], vec))
    want = _np_ret(sharded_retrieve_sq8(
        jmesh22, jnp.asarray(s["q"]), jax.device_put(a["codes"], row),
        *(jax.device_put(a[key], vec) for key in
          ("scales", "norm_sq", "labels", "ids")),
        jnp.asarray(s["excl"]), k=K, metric="L2", **kw))
    got = outs[0][("sq8", name)]
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_allclose(got["dists"], want["dists"], rtol=1e-4)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    # XLA fuses s * codes + c into an FMA: reconstructions an ulp apart
    np.testing.assert_allclose(got["neighbors"], want["neighbors"],
                               rtol=1e-5, atol=1e-5)
    _same_answers(got, outs[0][("sq8_plain", name)], rtol=0)


def test_sharded_ivf_masked_matches_jax(index_world, jmesh22):
    """The masked sharded IVF (replicated centroids, nprobe 8) against
    JAX's sharded_retrieve with centroids on the same mesh shape."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radad_tpu.parallel.sharded_index import sharded_retrieve

    p, outs = index_world
    v = p["ivf"]
    row = NamedSharding(jmesh22, P("index", None))
    vec = NamedSharding(jmesh22, P("index"))
    want = _np_ret(sharded_retrieve(
        jmesh22, jnp.asarray(v["q"]), jax.device_put(v["cap_vectors"], row),
        jax.device_put(v["cap_labels"], vec),
        jax.device_put(v["cap_ids"], vec),
        jax.device_put(v["cap_ids"] >= 0, vec), jnp.full((8,), -2,
                                                          jnp.int32),
        k=K, metric="L2",
        centroids=jax.device_put(v["centroids"], NamedSharding(jmesh22,
                                                                P())),
        cells=jax.device_put(v["cells"], vec), nprobe=8))
    _same_answers(outs[0]["ivf_masked"], want)


@pytest.mark.parametrize("mode", ["batch", "self"])
def test_sharded_ivf_gather_matches_jax(index_world, jmesh22, mode):
    """The gather-probed sharded IVF against JAX's ShardedIndex.
    retrieve_gather on the same mesh shape, and its over-budget branch
    (budget 1: every shard scans) against JAX's: the same answers as the
    gather route. Both modes; self mode on stored rows drops exactly each
    query's own row."""
    from radad_tpu.parallel.sharded_index import (
        ShardedIndex, sharded_retrieve_ivf_gather)

    p, outs = index_world
    v = p["ivf"]
    q, excl, nprobe = ((v["q"], v["excl"], 8) if mode == "batch"
                       else (v["q_self"], v["excl_self"], 16))
    jix = ShardedIndex(jmesh22, v["vecs"].shape[1], metric="L2")
    jix.build(v["vecs"], v["labels"], v["ids"])
    jix.build_ivf(v["centroids"], v["cells"])
    assert outs[0][("gather_budget", mode)] == jix.gather_budget(nprobe)
    want = _np_ret(jix.retrieve_gather(jnp.asarray(q), jnp.asarray(excl),
                                       K, nprobe, exclude_mode=mode))
    _same_answers(outs[0][("gather", mode)], want)
    want_fb = _np_ret(sharded_retrieve_ivf_gather(
        jmesh22, jnp.asarray(q), jix.vectors, jix.labels, jix.ids,
        jnp.asarray(excl), jix.centroids, jix.cells, jix.chunk_rows,
        jix.cell_chunks, jix.n_valid_shard, k=K, nprobe=nprobe, budget=1,
        metric="L2", exclude_mode=mode))
    assert all(o[("gather_budget1_scanned", mode)] for o in outs)
    _same_answers(outs[0][("gather_budget1", mode)], want_fb)
    np.testing.assert_array_equal(outs[0][("gather_budget1", mode)]
                                  ["indices"], want["indices"])
    if mode == "batch":
        _same_answers(outs[0][("gather", mode)], outs[0]["gather_plain"],
                      rtol=0)
    else:
        assert not (outs[0][("gather", mode)]["indices"]
                    == v["self_rows"][:, None]).any()


def test_build_sharded_chunk_tables_same_bytes(rng):
    """build_sharded_chunk_tables gives JAX's bytes (tables, per-shard
    valid counts and budget statistics), padding rows in no table."""
    from radad_tpu.parallel.sharded_index import (
        build_sharded_chunk_tables as jbuild)

    for n, cap, nlist, shards in ((500, 512, 16, 2), (1000, 1024, 32, 4),
                                  (77, 80, 5, 8)):
        cells = np.zeros((cap,), np.int32)
        cells[:n] = rng.integers(0, nlist, n)
        got = tsi.build_sharded_chunk_tables(cells, n, nlist, shards)
        want = jbuild(cells, n, nlist, shards)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        for (gc, gn), (wc, wn) in zip(got[3], want[3]):
            assert gc.tobytes() == wc.tobytes()
            np.testing.assert_array_equal(gn, wn)
