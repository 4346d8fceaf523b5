"""The port's IVF index against the JAX package on the CPU: the inverted
list builders byte for byte, both gather searches (span and chunked, the
chunked one's over-budget scan, both exclusion modes, k above the
candidate count), and ``FlatIndex``'s IVF mode: index files written by
either package, the gather and masked routes with the nprobe override, a
search larger than ``search_chunk``, bf16 storage, adds that assign
without retraining, the nlist clamp and ``use_pallas``.

The data are Gaussian mixtures whose queries' probe margins (the gap
between the nprobe-th and the next centroid distance) exceed f32 rounding
ten times over, asserted by ``_assert_probe_margins``: the two packages
sum the centroid distances in different orders, and a flipped probe would
change the candidate set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.index import flat as jflat
from radad_tpu.index import ivf_gather as jig
from radad_tpu_torch.index import flat as tflat
from radad_tpu_torch.index import ivf_gather as tig

K = 5


def _mixture(rng, n, d, comps, spread=3.0):
    """``n`` rows of a ``comps``-component Gaussian mixture in D = ``d``,
    and its component centers."""
    centers = rng.standard_normal((comps, d)) * spread
    x = centers[rng.integers(0, comps, n)] + rng.standard_normal((n, d))
    return x.astype(np.float32), centers.astype(np.float32)


def _assert_probe_margins(q, cents, nprobe):
    """Every query's nprobe-th and (nprobe+1)-th nearest centroid distances
    (f64) differ by more than 10 times the f32 rounding of the
    expanded distance, 2^-21 (|q|^2 + max |c|^2) + 2 sqrt(D) 2^-24
    (|c|^2 + 2 sum |q_d c_d|)."""
    q64, c64 = np.asarray(q, np.float64), np.asarray(cents, np.float64)
    if nprobe >= len(c64):
        return
    d64 = ((q64[:, None, :] - c64[None]) ** 2).sum(-1)
    s = np.sort(d64, 1)
    qsq, csq = (q64 ** 2).sum(-1), (c64 ** 2).sum(-1)
    terms = csq[None] + 2.0 * (np.abs(q64) @ np.abs(c64).T)
    bound = (2.0 ** -21 * (qsq + csq.max())
             + 2.0 * q64.shape[1] ** 0.5 * 2.0 ** -24 * terms.max(1))
    margin = s[:, nprobe] - s[:, nprobe - 1]
    assert (margin > 10.0 * bound).all(), (margin.min(), bound.max())


def _assert_same(got, want):
    """Identical ids, distances within 1e-5 relative."""
    gd, gi = (np.asarray(a) for a in got[:2])
    wd, wi = (np.asarray(a) for a in want[:2])
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ the tables
@pytest.mark.parametrize("n,nlist,span_cap,chunk", [
    (3000, 64, None, 32),  # p99.9 span, a few cells in the overflow
    (500, 40, 8, 8),  # capped span: a long overflow
    (37, 16, None, 8),  # empty cells
    (0, 4, None, 8),  # no rows
])
def test_tables_match_jax_byte_for_byte(n, nlist, span_cap, chunk, rng):
    """build_cell_table, build_chunk_table and default_chunk_budget equal
    the JAX package's, dtypes included, on skewed cell sizes; rows past
    n_valid are ignored."""
    w = rng.dirichlet(np.full(nlist, 0.3))
    cells = rng.choice(nlist, size=n + 11, p=w).astype(np.int32)
    if n == 37:
        cells[cells % 3 == 0] = 1  # cells 0, 3, 6, ... empty
    got = tig.build_cell_table(cells, n, nlist, span_cap=span_cap)
    want = jig.build_cell_table(cells, n, nlist, span_cap=span_cap)
    got += tig.build_chunk_table(cells, n, nlist, chunk=chunk)
    want += jig.build_chunk_table(cells, n, nlist, chunk=chunk)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        np.testing.assert_array_equal(g, w_)
    for nprobe in (1, 3, 32):
        assert tig.default_chunk_budget(got[4], got[5], nprobe) == \
            jig.default_chunk_budget(want[4], want[5], nprobe)


# ------------------------------------------------------ the gather searches
def _gather_case(rng, store, n=1500, d=64, nlist=48, cap=2048):
    """Rows (cap, zero pad rows past n, ids -1 there), centroids near the
    mixture's centers, every row's nearest cell (f64), and the JAX
    package's tables; queries near stored rows."""
    x, centers = _mixture(rng, n, d, nlist)
    cents = (centers + 0.1 * rng.standard_normal(centers.shape)).astype(
        np.float32)
    cells = np.zeros((cap,), np.int32)
    cells[:n] = ((x[:, None, :].astype(np.float64) - cents[None]) ** 2
                 ).sum(-1).argmin(1)
    vec = np.zeros((cap, d), np.float32)
    vec[:n] = x
    if store == "bf16":
        vec = np.array(jnp.asarray(vec, jnp.bfloat16).astype(jnp.float32))
    ids = np.full((cap,), -1, np.int32)
    ids[:n] = np.arange(n) % 97
    b = 12
    rows = rng.integers(0, n, b)
    q = (x[rows] + 0.3 * rng.standard_normal((b, d))).astype(np.float32)
    excl = (rows % 97).astype(np.int32)
    return dict(vec=vec, ids=ids, cells=cells, cents=cents, q=q, excl=excl,
                n=n, xsq=(vec.astype(np.float64) ** 2).sum(-1).astype(
                    np.float32))


def _both(c, store):
    """The case's arrays for JAX (jnp) and for the port (CPU tensors), the
    rows in the storage dtype."""
    j = {k: jnp.asarray(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    t = {k: torch.as_tensor(v) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    if store == "bf16":
        j["vec"] = j["vec"].astype(jnp.bfloat16)
        t["vec"] = t["vec"].to(torch.bfloat16)
    return j, t


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["batch", "self"])
@pytest.mark.parametrize("table", ["span", "span_capped", "chunked",
                                   "chunked_over_budget"])
def test_gather_searches_match_jax(table, mode, store, rng):
    """ivf_gather_search / ivf_gather_search_chunked against the JAX
    package's jitted functions on the same arrays: identical ids,
    distances within 1e-5 relative; no excluded id returned. A span cap
    of 8 rows puts most rows in the overflow that every query scans; a
    budget of 1 chunk sends the chunked search to its dense masked scan
    (the port reports it)."""
    c = _gather_case(rng, store)
    nprobe = 3
    _assert_probe_margins(c["q"], c["cents"], nprobe)
    j, t = _both(c, store)
    nlist = len(c["cents"])
    args = ("q", "vec", "xsq", "ids", "excl", "cents")
    if table.startswith("span"):
        tab, _, ovf = jig.build_cell_table(
            c["cells"], c["n"], nlist,
            span_cap=8 if table == "span_capped" else None)
        want = jig.ivf_gather_search(
            *(j[a] for a in args), jnp.asarray(tab), jnp.asarray(ovf), K,
            nprobe=nprobe, exclude_mode=mode)
        got = tig.ivf_gather_search(
            *(t[a] for a in args), torch.as_tensor(tab),
            torch.as_tensor(ovf), K, nprobe=nprobe, exclude_mode=mode)
    else:
        rows, cc, counts = jig.build_chunk_table(c["cells"], c["n"], nlist,
                                                 chunk=16)
        budget = (1 if table == "chunked_over_budget"
                  else jig.default_chunk_budget(cc, counts, nprobe))
        kw = dict(nprobe=nprobe, budget=budget, n_valid=c["n"],
                  exclude_mode=mode)
        want = jig.ivf_gather_search_chunked(
            *(j[a] for a in args), jnp.asarray(rows), jnp.asarray(cc),
            j["cells"], K, **kw)
        got = tig.ivf_gather_search_chunked(
            *(t[a] for a in args), torch.as_tensor(rows),
            torch.as_tensor(cc), t["cells"], K, **kw)
        assert got[2] == (table == "chunked_over_budget")
    _assert_same(got, want)
    out = c["ids"][got[1].numpy()]
    if mode == "self":
        assert not (out == c["excl"][:, None]).any()
    else:
        assert not np.isin(out, c["excl"]).any()


@pytest.mark.parametrize("table", ["span", "chunked"])
def test_gather_search_pads_k_beyond_candidates(table, rng):
    """k above the candidate count: the JAX package's (+inf, -1) slots."""
    c = _gather_case(rng, "f32", n=40, d=16, nlist=8, cap=1024)
    j, t = _both(c, "f32")
    args = ("q", "vec", "xsq", "ids", "excl", "cents")
    k = 48
    if table == "span":
        tab, _, ovf = jig.build_cell_table(c["cells"], c["n"], 8)
        want = jig.ivf_gather_search(
            *(j[a] for a in args), jnp.asarray(tab), jnp.asarray(ovf), k,
            nprobe=1)
        got = tig.ivf_gather_search(
            *(t[a] for a in args), torch.as_tensor(tab),
            torch.as_tensor(ovf), k, nprobe=1)
    else:
        rows, cc, _ = jig.build_chunk_table(c["cells"], c["n"], 8, chunk=8)
        kw = dict(nprobe=1, budget=2, n_valid=c["n"])
        want = jig.ivf_gather_search_chunked(
            *(j[a] for a in args), jnp.asarray(rows), jnp.asarray(cc),
            j["cells"], k, **kw)
        got = tig.ivf_gather_search_chunked(
            *(t[a] for a in args), torch.as_tensor(rows),
            torch.as_tensor(cc), t["cells"], k, **kw)
    assert got[1].shape == (12, k) and (got[1].numpy() == -1).any()
    assert np.isinf(got[0].numpy()[got[1].numpy() < 0]).all()
    _assert_same(got, want)


# ------------------------------------------------------------ FlatIndex
D, NLIST, NPROBE = 64, 32, 3


def _rows(rng, n=3000):
    x, _ = _mixture(rng, n, D, 40)
    return (x, [float(i % 2) for i in range(n)],
            [f"c{i}.wav" for i in range(n)], list(range(n)))


def _queries(rng, x, b):
    rows = rng.integers(0, len(x), b)
    return ((x[rows] + 0.1 * rng.standard_normal((b, D))).astype(np.float32),
            rows.astype(np.int32))


def _searches(jidx, tidx, q, excl, nprobes=(NPROBE, 6)):
    """Each search of both indexes on the same queries: the gate's pick, the
    forced gather and masked routes, at each nprobe; identical ids,
    distances within 1e-5 relative. → the port's route counts."""
    cents = tidx.centroids.numpy()
    for nprobe in nprobes:
        _assert_probe_margins(q, cents, nprobe)
        for gather in (None, True, False):
            kw = dict(exclude_ids=excl, nprobe=nprobe, gather=gather)
            _assert_same(tidx.search(q, K, **kw), jidx.search(q, K, **kw))
    return tidx.ivf_gather_searches, tidx.searches


@pytest.mark.parametrize("use_float16", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ivf_index_files_cross_and_search_alike(writer, use_float16, rng,
                                                tmp_path):
    """An IVF index built and saved by one package loads in the other with
    the same centroids, cells and meta (nothing retrained), and every
    search (B = 2, which the gate sends to the gather route, and B = 24,
    which it sends to the masked route; both forced; nprobe 3 and 6) gives
    identical ids."""
    x, lab, paths, ids = _rows(rng)
    kw = dict(nlist=NLIST, nprobe=NPROBE, ivf_balance=0.5,
              ivf_retrain_on_add=False, use_float16=use_float16)
    if writer == "jax":
        jidx = jflat.FlatIndex(D, "IVF", **kw)
        jidx.add(x, lab, paths, ids=ids)
        jidx.save(str(tmp_path))
        tidx = tflat.FlatIndex.load(str(tmp_path), device="cpu")
    else:
        tidx = tflat.FlatIndex(D, "IVF", device="cpu", **kw)
        tidx.add(x, lab, paths, ids=ids)
        tidx.save(str(tmp_path))
        jidx = jflat.FlatIndex.load(str(tmp_path))
    n = len(x)
    assert (tidx.nlist, tidx.nprobe, tidx.ivf_balance,
            tidx.ivf_retrain_on_add, tidx.use_float16) == \
        (jidx.nlist, jidx.nprobe, jidx.ivf_balance, jidx.ivf_retrain_on_add,
         jidx.use_float16)
    assert tidx.nlist_effective == jidx.nlist_effective == NLIST
    np.testing.assert_array_equal(tidx.centroids.numpy(),
                                  np.asarray(jidx.centroids))
    np.testing.assert_array_equal(tidx.cells[:n].numpy(),
                                  np.asarray(jidx.cells)[:n])
    for name in ("ivf_table", "ivf_overflow", "ivf_chunk_rows",
                 "ivf_cell_chunks"):
        np.testing.assert_array_equal(getattr(tidx, name).numpy(),
                                      np.asarray(getattr(jidx, name)))
    for b in (2, 24):
        q, rows = _queries(rng, x, b)
        before = tidx.ivf_gather_searches
        budget = tidx.chunk_budget(NPROBE)
        gathered = 2 * b * budget * tidx.ivf_chunk_rows.shape[1] < n
        assert gathered == (b == 2)
        tidx.search(q, K, exclude_ids=rows)
        assert tidx.ivf_gather_searches == before + gathered
        _searches(jidx, tidx, q, rows)
    assert tidx.route == "certified" and tidx.fallbacks == 0


@pytest.mark.parametrize("gather", [None, True, False])
def test_ivf_search_above_search_chunk_matches_jax(gather, rng, tmp_path):
    """40 queries through search_chunk = 16 (a padded tail chunk) with one
    call-global exclusion set, on the JAX package's index files: identical
    ids on each route."""
    x, lab, paths, ids = _rows(rng)
    jidx = jflat.FlatIndex(D, "IVF", nlist=NLIST, nprobe=NPROBE)
    jidx.add(x, lab, paths, ids=ids)
    jidx.save(str(tmp_path))
    tidx = tflat.FlatIndex.load(str(tmp_path), device="cpu")
    jidx.search_chunk = tidx.search_chunk = 16
    q, rows = _queries(rng, x, 40)
    _assert_probe_margins(q, tidx.centroids.numpy(), NPROBE)
    kw = dict(exclude_ids=rows, gather=gather)
    got = tidx.search(q, K, **kw)
    _assert_same(got, jidx.search(q, K, **kw))
    assert not np.isin(np.asarray(ids)[got[1]], rows).any()


def test_ivf_add_without_retrain_matches_jax_extend(rng, tmp_path):
    """ivf_retrain_on_add=False: from the same trained quantizer (the JAX
    package's, through its files), an add that grows capacity assigns the
    new rows to the trained cells as the JAX package's _extend_ivf does:
    centroids kept, cells and tables equal, searches identical."""
    x, lab, paths, ids = _rows(rng, 2500)
    a = 700
    jidx = jflat.FlatIndex(D, "IVF", nlist=NLIST, nprobe=NPROBE,
                           ivf_retrain_on_add=False)
    jidx.add(x[:a], lab[:a], paths[:a], ids=ids[:a])
    jidx.save(str(tmp_path))
    tidx = tflat.FlatIndex.load(str(tmp_path), device="cpu")
    cents = tidx.centroids.clone()
    jidx.add(x[a:], lab[a:], paths[a:], ids=ids[a:])
    tidx.add(x[a:], lab[a:], paths[a:], ids=ids[a:])
    n = len(x)
    assert tidx.vectors.shape[0] == 3072 and tidx.cells.shape[0] == 3072
    assert torch.equal(tidx.centroids, cents)
    np.testing.assert_array_equal(tidx.cells[:n].numpy(),
                                  np.asarray(jidx.cells)[:n])
    for name in ("ivf_table", "ivf_overflow", "ivf_chunk_rows",
                 "ivf_cell_chunks"):
        np.testing.assert_array_equal(getattr(tidx, name).numpy(),
                                      np.asarray(getattr(jidx, name)))
    q, rows = _queries(rng, x, 4)
    _searches(jidx, tidx, q, rows, nprobes=(NPROBE,))


def test_ivf_nlist_clamps_and_retrains_on_add(rng):
    """nlist above the training rows clamps nlist_effective to them, as in
    the JAX package; with ivf_retrain_on_add (the default) a later add
    retrains on the stored rows and regains the configured cell count."""
    x, lab, paths, ids = _rows(rng, 600)
    tidx = tflat.FlatIndex(D, "IVF", nlist=100, device="cpu")
    jidx = jflat.FlatIndex(D, "IVF", nlist=100)
    for lo, hi in ((0, 60), (60, 600)):
        tidx.add(x[lo:hi], lab[lo:hi], paths[lo:hi], ids=ids[lo:hi])
        jidx.add(x[lo:hi], lab[lo:hi], paths[lo:hi], ids=ids[lo:hi])
        assert tidx.nlist_effective == jidx.nlist_effective == min(100, hi)
        assert tidx.centroids.shape == (min(100, hi), D)
        assert tidx.ivf_table.shape[0] == min(100, hi)
    # every row sits in its nearest trained cell
    np.testing.assert_array_equal(
        tidx.cells[:600].numpy(),
        tflat._assign_cells(torch.as_tensor(x), tidx.centroids).numpy())
    assert tidx.nlist == 100 and tidx.ivf_counts.sum() == 600


def test_ivf_keeps_the_certified_route_under_use_pallas(rng, monkeypatch,
                                                        tmp_path):
    """FlatIndex(use_pallas=True) on IVF never reaches flat_topk (JAX
    flat.py:1199-1216): the masked route is the certified search, the
    same ids as without use_pallas."""
    calls = []
    monkeypatch.setattr(tflat, "flat_topk",
                        lambda *a, **kw: calls.append(1))
    x, lab, paths, ids = _rows(rng, 1500)
    plain = tflat.FlatIndex(D, "IVF", nlist=NLIST, nprobe=NPROBE,
                            device="cpu")
    plain.add(x, lab, paths, ids=ids)
    plain.save(str(tmp_path))
    pallas = tflat.FlatIndex.load(str(tmp_path), use_pallas=True,
                                  device="cpu")
    assert pallas.route == "certified"
    q, rows = _queries(rng, x, 8)
    for gather in (False, None):
        _assert_same(pallas.search(q, K, exclude_ids=rows, gather=gather),
                     plain.search(q, K, exclude_ids=rows, gather=gather))
    assert not calls and pallas.searches >= 1
