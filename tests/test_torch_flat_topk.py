"""Port ``flat_topk`` and the ``use_pallas`` search route against the JAX
package on the CPU: the scan + per-tile k-select (its plain version here)
against the Pallas kernel in interpret mode, ``FlatIndex(use_pallas=True)``
in both packages, a JAX-written index loaded with ``use_pallas``, and a
WavLM ``DetectionPipeline(use_pallas=True)`` against the JAX pipeline.
The CUDA kernel's cases are in tests/test_torch_cuda.py."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.index import flat as jflat
from radad_tpu.ops import topk as jtopk
from radad_tpu_torch.index import flat as tflat
from radad_tpu_torch.ops.topk import (flat_topk, flat_topk_plain,
                                      flat_topk_reference)

from test_torch_wavlm import TINY_LM


@pytest.fixture
def interpret_flat_topk(monkeypatch):
    """Route the JAX index's flat_topk through Pallas interpret mode, as
    tests/test_torch_index.py does for exact_dot."""
    monkeypatch.setattr(jtopk, "flat_topk", functools.partial(
        jtopk.flat_topk, interpret=True))


def _case(rng, n=700, d=96, b=9):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    ids = (np.arange(n) % 97).astype(np.int32)
    excl = (np.arange(b) % 97).astype(np.int32)
    return q, x, ids, excl


@pytest.mark.parametrize("fast_scan", [False, True])
@pytest.mark.parametrize("k", [5, 32])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_flat_topk_matches_pallas_interpret(metric, k, fast_scan, rng):
    """Ids identical (no near-ties in this data), values within 1e-4
    relative; rows >= n_valid and each query's excluded id masked."""
    q, x, ids, excl = _case(rng)
    kw = dict(metric=metric, n_valid=650)
    jv, ji = jtopk.flat_topk(jnp.asarray(q), jnp.asarray(x), k,
                             ids=jnp.asarray(ids),
                             exclude_ids=jnp.asarray(excl), tile_n=256,
                             chunk_d=64, interpret=True, fast_scan=fast_scan,
                             **kw)
    targs = (torch.as_tensor(q), torch.as_tensor(x), k)
    tkw = dict(kw, ids=torch.as_tensor(ids), exclude_ids=torch.as_tensor(excl),
               fast_scan=fast_scan)
    before = flat_topk.launches
    tv, ti = flat_topk(*targs, **tkw)
    assert flat_topk.launches == before  # CPU tensors: the plain version
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-4)
    assert (ti.numpy() < 650).all()
    assert not (ids[ti.numpy()] == excl[:, None]).any()
    if not fast_scan:
        # f32 scores: the oracle's values (its -(|q|^2 - 2q.x + |x|^2)
        # rounds otherwise, so near-tied neighbors may trade places)
        rv, _ = flat_topk_reference(*targs, **{n: v for n, v in tkw.items()
                                               if n != "fast_scan"})
        np.testing.assert_allclose(rv.numpy(), tv.numpy(), rtol=1e-4,
                                   atol=1e-3)


def test_flat_topk_missing_slots_and_bf16_rows(rng):
    """More slots than unmasked rows: (-inf, -1) after the found ones, as
    the JAX kernel; bf16 rows score on their stored values."""
    q, x, _, _ = _case(rng, n=40, d=64, b=3)
    v, i = flat_topk_plain(torch.as_tensor(q), torch.as_tensor(x), 32,
                           n_valid=20, fast_scan=True)
    jv, ji = jtopk.flat_topk(jnp.asarray(q), jnp.asarray(x), 32, n_valid=20,
                             interpret=True, fast_scan=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert (i[:, 20:] == -1).all() and torch.isinf(v[:, 20:]).all()
    xb = torch.as_tensor(x).to(torch.bfloat16)
    vb, ib = flat_topk(torch.as_tensor(q), xb, 5, metric="IP")
    rv, ri = flat_topk_reference(torch.as_tensor(q), xb.float(), 5,
                                 metric="IP")
    np.testing.assert_array_equal(ib.numpy(), ri.numpy())
    with pytest.raises(ValueError):
        flat_topk(torch.as_tensor(q), xb, 129)
    with pytest.raises(ValueError):
        flat_topk(torch.as_tensor(q), xb, 5, metric="IVF")


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("use_float16", [False, True])
def test_use_pallas_index_matches_jax(metric, use_float16, rng,
                                      interpret_flat_topk):
    """FlatIndex(use_pallas=True).search: flat_topk over-fetches
    max(4k, 32) candidates, the exact f32 re-rank orders them; batch-global
    exclusion."""
    n, d = 900, 128
    x = rng.standard_normal((n, d)).astype(np.float32)
    labels = [0.0] * n
    paths = [f"c{i}.wav" for i in range(n)]
    ids = [i % 211 for i in range(n)]
    q = rng.standard_normal((10, d)).astype(np.float32)
    excl = np.arange(10, dtype=np.int32) * 3
    jidx = jflat.FlatIndex(d, metric, use_pallas=True,
                           use_float16=use_float16)
    jidx.add(x, labels, paths, ids=ids)
    tidx = tflat.FlatIndex(d, metric, use_pallas=True,
                           use_float16=use_float16, device="cpu")
    tidx.add(x, labels, paths, ids=ids)
    jd, ji = jidx.search(q, 5, exclude_ids=excl)
    td, ti = tidx.search(q, 5, exclude_ids=excl)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-3)
    assert not np.isin(np.asarray(ids)[ti], excl).any()
    assert tidx.fallbacks == 0 and tidx.searches == 1


def test_jax_written_use_pallas_index_loads_in_port(rng, tmp_path,
                                                    interpret_flat_topk):
    n, d = 600, 64
    x = rng.standard_normal((n, d)).astype(np.float32)
    labels = (rng.random(n) > 0.5).astype(np.float32).tolist()
    paths = [f"/data/clip_{i:04d}.wav" for i in range(n)]
    jidx = jflat.FlatIndex(d, "L2", use_pallas=True)
    jidx.add(x, labels, paths, ids=list(range(n)))
    jidx.save(str(tmp_path))
    tidx = tflat.FlatIndex.load(str(tmp_path), use_pallas=True, device="cpu")
    assert tidx.use_pallas and tidx.ntotal == n and tidx.paths == paths
    q = x[:7] + 0.01 * rng.standard_normal((7, d)).astype(np.float32)
    excl = np.arange(7, dtype=np.int32)
    jd, ji = jidx.search(q, 5, exclude_ids=excl)
    td, ti = tidx.search(q, 5, exclude_ids=excl)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-3)
    assert not tflat.FlatIndex.load(str(tmp_path), device="cpu").use_pallas


@pytest.fixture(scope="module")
def wavlm_pair(tmp_path_factory, synthetic_dataset):
    """A JAX pipeline and a port pipeline (use_pallas=True) with the same
    tiny WavLM encoder and fusion weights, each with its DB built from the
    same training split. The JAX pipeline's predict path searches with its
    exact f32 scan (its retrieve_on_device pins use_pallas=False)."""
    from radad_tpu.config import Config as JConfig
    from radad_tpu.data.manifest import load_manifests
    from radad_tpu.models.encoder import FrozenEncoder as JEnc
    from radad_tpu.models.wavlm import WavLMConfig as JL, init_params
    from radad_tpu.train.pipeline import DetectionPipeline as JPipe
    from radad_tpu_torch.config import Config as TConfig
    from radad_tpu_torch.models.convert import fusion_from_flax, wavlm_from_jax
    from radad_tpu_torch.models.encoder import FrozenEncoder as TEnc
    from radad_tpu_torch.models.wavlm import WavLMConfig as TL
    from radad_tpu_torch.train.pipeline import DetectionPipeline as TPipe

    params = jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(4), JL(**TINY_LM)))
    jenc = JEnc(name="wavlm", model_name="tiny", arch_cfg=JL(**TINY_LM),
                params=params, pretrained=False)
    tenc = TEnc(name="wavlm", model_name="tiny", arch_cfg=TL(**TINY_LM),
                model=wavlm_from_jax(params, TL(**TINY_LM)), pretrained=False)
    splits = load_manifests(synthetic_dataset)
    pipes = []
    for name, cfg_cls in (("jax", JConfig), ("torch", TConfig)):
        root = str(tmp_path_factory.mktemp(f"wavlm_{name}"))
        cfg = cfg_cls().replace(
            data_root=root, vector_db_path=os.path.join(root, "vdb"),
            db_batch_size=8, use_layer_norm=True, use_batch_norm=False,
            feature_extractor_type="wavlm")
        if name == "jax":
            pipe = JPipe(cfg, encoder=jenc)
            pipe._ensure_model_state()
        else:
            pipe = TPipe(cfg, encoder=tenc, use_pallas=True, device="cpu")
            fusion_from_flax(pipe.model, jax.tree_util.tree_map(
                np.asarray, pipes[0].variables))
        pipe.build_vector_database(splits["train"])
        pipes.append(pipe)
    return pipes[0], pipes[1], splits


@pytest.mark.parametrize("split", ["val", "train"])
def test_wavlm_use_pallas_pipeline_matches_jax(wavlm_pair, split):
    """Same WAVs, crossed weights: neighbor ids identical, logits within
    1e-4 (train clips exercise per-row self exclusion)."""
    jpipe, tpipe, splits = wavlm_pair
    assert tpipe.index.use_pallas
    np.testing.assert_allclose(
        tpipe.index.vectors[: tpipe.index.ntotal].numpy(),
        np.asarray(jpipe.index.vectors)[: jpipe.index.ntotal],
        rtol=1e-4, atol=5e-4)
    paths = list(splits[split].paths[:6])
    jout, tout = jpipe.predict_batch(paths), tpipe.predict_batch(paths)
    for path, j, t in zip(paths, jout, tout):
        assert t["retrieved_files"] == j["retrieved_files"], path
        assert abs(t["logit"] - j["logit"]) < 1e-4, path
        np.testing.assert_allclose(
            [r["distance"] for r in t["retrieved"]],
            [r["distance"] for r in j["retrieved"]], rtol=1e-4, atol=1e-3)
        assert os.path.basename(path) not in t["retrieved_files"]
    j, t = jpipe.predict(paths[0]), tpipe.predict(paths[0])
    assert t["retrieved_files"] == j["retrieved_files"]
    assert abs(t["logit"] - j["logit"]) < 1e-4


def test_wavlm_pipeline_db_reload_keeps_use_pallas(wavlm_pair):
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    _, tpipe, splits = wavlm_pair
    other = DetectionPipeline(tpipe.config, encoder=tpipe.encoder,
                              use_pallas=True, device="cpu")
    assert other.load_vector_database()
    assert other.index.use_pallas and other.index.ntotal == \
        tpipe.index.ntotal
    path = splits["val"].paths[2]
    other.model.load_state_dict(tpipe.model.state_dict())
    assert other.predict(path)["retrieved_files"] == \
        tpipe.predict(path)["retrieved_files"]


def test_topk_agreement_explains_only_near_ties(rng):
    """The kernel-vs-plain comparison accepts equal results and a swap of
    two rows tied within their rounding bounds, and rejects a swap that is
    not."""
    from radad_tpu_torch.ops.topk_check import compare_topk

    q, x, _, _ = _case(rng, n=128, d=64, b=4)
    x[5] = x[4]  # an exact tie
    tq, tx = torch.as_tensor(q), torch.as_tensor(x)
    v, i = flat_topk_plain(tq, tx, 128, fast_scan=True)
    assert compare_topk(tq, tx, (v, i), (v, i))["ok"]
    tied = i.clone()
    p4, p5 = int((i[0] == 4).nonzero()), int((i[0] == 5).nonzero())
    tied[0, p4], tied[0, p5] = 5, 4
    assert compare_topk(tq, tx, (v, tied), (v, i))["ok"]
    far = i.clone()
    far[0, 0], far[0, 1] = i[0, 127], i[0, 0]
    out = compare_topk(tq, tx, (v, far), (v, i))
    assert not out["ok"] and out["rows_differ"] == 1


def _kernel_order_f32(q, x):
    """f32 emulation of csrc/flat_topk.cu's L2 score on bf16-rounded
    operands, pair by pair (``q [P, D]``, ``x [P, D]``): one rounding per
    step of the column-ordered q.x chain; |x|^2 as 8 loader threads' sums
    of 4-column groups joined by a 3-level tree; then the wrapper's
    subtraction of its f32 |q|^2."""
    qb = q.to(torch.bfloat16).double()
    xb = x.to(torch.bfloat16).double()
    acc = torch.zeros(q.shape[0], dtype=torch.float32)
    for c in range(q.shape[1]):
        acc = (acc.double() + qb[:, c] * xb[:, c]).float()
    sq = (x * x).reshape(x.shape[0], -1, 8, 4)  # f32 squares
    s4 = ((sq[..., 0] + sq[..., 1]) + sq[..., 2]) + sq[..., 3]
    run = torch.zeros_like(s4[:, 0])
    for c in range(s4.shape[1]):
        run = run + s4[:, c]
    while run.shape[1] > 1:
        run = run[:, 0::2] + run[:, 1::2]
    score = 2.0 * acc - run[:, 0]
    return score - q.square().sum(-1)


@pytest.mark.parametrize("data", ["randn", "positive", "offset"])
def test_pair_scores_bound_holds_for_the_kernel_order(data, rng):
    """The f32 emulation of the kernel's summation order stays within
    ``pair_scores``' bound of the exact value, also where the partial sums
    grow without cancelling (positive data) and on large norms; the bound
    is far below the order-free worst case gamma_D * sum|terms|."""
    from radad_tpu_torch.ops.topk_check import U, pair_scores

    p, d = 48, 512
    q = rng.standard_normal((p, d)).astype(np.float32)
    x = rng.standard_normal((p, d)).astype(np.float32)
    if data == "positive":
        q, x = np.abs(q), np.abs(x)
    elif data == "offset":
        x += 30.0
    tq, tx = torch.as_tensor(q), torch.as_tensor(x)
    exact, bound = pair_scores(tq, tx, torch.arange(p)[:, None])
    err = (_kernel_order_f32(tq, tx).double() - exact[:, 0]).abs()
    assert bool((err <= bound[:, 0]).all())
    qb = tq.to(torch.bfloat16).double()
    terms = (2.0 * (qb * tx.to(torch.bfloat16).double()).abs()
             + tx.double().square()).sum(-1) + tq.double().square().sum(-1)
    assert bool((bound[:, 0] < 0.5 * d * U * terms).all())


@pytest.mark.parametrize("fault", ["none", "unrounded", "dropped_columns",
                                   "masked_row", "left_out", "value"])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_check_topk_holds_plain_and_catches_faults(metric, fault, rng):
    """``check_topk`` passes the plain version and fails each fault a
    kernel could have: no bf16 rounding, dropped columns, a masked row
    returned, a better row left out, a value off by more than its bound."""
    from radad_tpu_torch.ops.topk_check import check_topk

    q, x, ids, excl = _case(rng, n=700, d=96, b=9)
    tq, tx = torch.as_tensor(q), torch.as_tensor(x)
    kw = dict(metric=metric, n_valid=650, ids=torch.as_tensor(ids),
              exclude_ids=torch.as_tensor(excl))
    v, i = flat_topk_plain(tq, tx, 32, fast_scan=fault != "unrounded", **kw)
    if fault == "dropped_columns":
        cut = tx.clone()
        cut[:, 40:43] = 0.0
        v, i = flat_topk_plain(tq, cut, 32, fast_scan=True, **kw)
    elif fault == "masked_row":
        i = i.clone()
        i[0, 3] = 680  # past n_valid
    elif fault == "left_out":  # ranks 2..33: the best row is missing
        v, i = flat_topk_plain(tq, tx, 33, fast_scan=True, **kw)
        v, i = v[:, 1:], i[:, 1:]
    elif fault == "value":
        v = v.clone()
        v[2, 0] += 1e-3
    out = check_topk(tq, tx, (v, i), fast_scan=True, **kw)
    assert out["ok"] == (fault == "none"), out
    reason = {"masked_row": "past n_valid", "left_out": "left out"}.get(
        fault, "off its exact score")
    assert fault == "none" or any(reason in m for m in out["problems"]), out
    if fault == "none":
        assert out["max_abs_err"] <= out["max_bound"] < 1e-2
