"""The port's IVF pipeline against the JAX package's on the CPU: predict and
predict_batch on both sides of the gather gate on the JAX package's DB
files, two train steps, the CLI's IVF flags (a DB the port builds, which
the JAX package loads and searches alike) and the server's --nprobe.

The DB is the synthetic training split's clips plus seeded rows around
them, so that one clip's predict passes the gate of JAX's single-device
dispatch (2 B budget chunk < n) and a batch of five does not."""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from radad_tpu.index import flat as jflat
from radad_tpu_torch.index import flat as tflat

from test_torch_ivf import _assert_probe_margins, _assert_same
from test_torch_sq8 import hold_two_train_steps

NLIST, NPROBE, PAD_ROWS = 16, 2, 320


def _pipe_kw(root, vdb=None):
    return dict(data_root=root, vector_db_path=vdb or os.path.join(root, "vdb"),
                db_batch_size=8, batch_size=8, eval_batch_size=8,
                vector_db_index_type="IVF", vector_db_nlist=NLIST,
                vector_db_nprobe=NPROBE, projection_dropout=0.0,
                detection_dropout=0.0)


@pytest.fixture(scope="module")
def ivf_pipes(tmp_path_factory, synthetic_dataset):
    """A JAX IVF pipeline whose DB (the training split plus PAD_ROWS seeded
    rows, k-means retrained on the add) is saved, and the port's pipeline
    on the same encoder and fusion weights that loaded it."""
    from radad_tpu.config import Config as JConfig
    from radad_tpu.data.manifest import load_manifests
    from radad_tpu.train.pipeline import DetectionPipeline as JPipe
    from radad_tpu_torch.config import Config as TConfig
    from radad_tpu_torch.models.convert import fusion_from_flax
    from radad_tpu_torch.train.pipeline import DetectionPipeline as TPipe

    from test_torch_train import _encoders, _np

    jenc, tenc = _encoders()
    splits = load_manifests(synthetic_dataset)
    jroot = str(tmp_path_factory.mktemp("jax_ivf"))
    troot = str(tmp_path_factory.mktemp("torch_ivf"))
    jpipe = JPipe(JConfig().replace(**_pipe_kw(jroot)), encoder=jenc)
    jpipe._ensure_model_state()
    jpipe.build_vector_database(splits["train"], save=False)
    ix = jpipe.index
    emb = np.asarray(ix.vectors)[: ix.ntotal]
    rng = np.random.default_rng(7)
    pad = (emb[rng.integers(0, len(emb), PAD_ROWS)] + 0.3 * emb.std(0)
           * rng.standard_normal((PAD_ROWS, emb.shape[1]))).astype(np.float32)
    ix.add(pad, [float(i % 2) for i in range(PAD_ROWS)],
           [f"pad_{i:04d}.wav" for i in range(PAD_ROWS)],
           ids=list(range(10**6, 10**6 + PAD_ROWS)))
    ix.save(jpipe.config.vector_db_path)
    tpipe = TPipe(TConfig().replace(**_pipe_kw(troot,
                                               jpipe.config.vector_db_path)),
                  encoder=tenc, device="cpu")
    fusion_from_flax(tpipe.model, _np(jpipe.variables))
    assert tpipe.load_vector_database()
    return jpipe, tpipe, splits


def _gate(tpipe, b):
    """JAX's single-device gate for a predict batch of ``b`` clips."""
    ix = tpipe.index
    budget = ix.chunk_budget(min(ix.nprobe, ix.ivf_cell_chunks.shape[0]))
    return 2 * b * budget * ix.ivf_chunk_rows.shape[1] < ix.ntotal


def test_ivf_db_loads_as_saved(ivf_pipes):
    """The port's pipeline holds the JAX package's IVF state as saved."""
    jpipe, tpipe, _ = ivf_pipes
    j, t = jpipe.index, tpipe.index
    n = j.ntotal
    assert t.metric == "IVF" and t.ntotal == n and t.paths == j.paths
    assert (t.nlist, t.nprobe, t.nlist_effective) == (NLIST, NPROBE, NLIST)
    np.testing.assert_array_equal(t.centroids.numpy(),
                                  np.asarray(j.centroids))
    np.testing.assert_array_equal(t.cells[:n].numpy(),
                                  np.asarray(j.cells)[:n])
    assert _gate(tpipe, 1) and not _gate(tpipe, 5)


@pytest.mark.parametrize("split", ["val", "train"])
def test_ivf_predict_matches_jax_on_both_sides_of_the_gate(ivf_pipes, split):
    """predict (B = 1: the chunked gather route) and predict_batch (B = 5:
    the unprobed certified search over every row) give JAX's neighbor
    files, logits within 1e-4 and distances within 1e-4; train clips
    exercise the self exclusion."""
    jpipe, tpipe, splits = ivf_pipes
    ix = tpipe.index
    paths = list(splits[split].paths[:5])
    emb = tpipe.get_embeddings(splits[split].subset(range(5)))
    _assert_probe_margins(emb.numpy(), ix.centroids.numpy(), NPROBE)
    gathers, searches = ix.ivf_gather_searches, ix.searches
    for path in paths:
        j, t = jpipe.predict(path), tpipe.predict(path)
        assert t["retrieved_files"] == j["retrieved_files"], path
        assert abs(t["logit"] - j["logit"]) < 1e-4, path
        np.testing.assert_allclose(
            [r["distance"] for r in t["retrieved"]],
            [r["distance"] for r in j["retrieved"]], rtol=1e-4, atol=1e-3)
        assert os.path.basename(path) not in t["retrieved_files"]
    assert ix.ivf_gather_searches == gathers + len(paths)
    assert ix.searches == searches
    for path, j, t in zip(paths, jpipe.predict_batch(paths),
                          tpipe.predict_batch(paths)):
        assert t["retrieved_files"] == j["retrieved_files"], path
        assert abs(t["logit"] - j["logit"]) < 1e-4, path
        np.testing.assert_allclose(
            [r["distance"] for r in t["retrieved"]],
            [r["distance"] for r in j["retrieved"]], rtol=1e-4, atol=1e-3)
    assert ix.searches == searches + 1 and ix.fallbacks == 0
    assert ix.ivf_gather_searches == gathers + len(paths)


@pytest.mark.parametrize("table", ["span", "chunked"])
def test_ivf_gather_retrieval_matches_jax(ivf_pipes, table):
    """JAX's retrieve_on_device_ivf_gather(_chunked) on the loaded DB
    against the port's ivf_gather_search + _gathered_to_neighbors (span)
    and retrieve_on_device_ivf_gather_chunked: neighbors (an XLA take in
    JAX; index_select here, no kernel), labels, distances and rows, on a
    batch of 8 with batch exclusion."""
    import jax.numpy as jnp

    from radad_tpu.train import pipeline as jp
    from radad_tpu_torch.index import ivf_gather as tg

    jpipe, tpipe, splits = ivf_pipes
    j, t = jpipe.index, tpipe.index
    tpp = tpipe.get_embeddings(splits["train"].subset(range(8)))
    _assert_probe_margins(tpp.numpy(), t.centroids.numpy(), NPROBE)
    ex = splits["train"].ids[:8].astype(np.int32)
    jq, jex = jnp.asarray(tpp.numpy()), jnp.asarray(ex)
    tex = torch.as_tensor(ex)
    head = ("vectors", "norms_sq", "labels", "ids")
    if table == "span":
        want = jp.retrieve_on_device_ivf_gather(
            jq, *(getattr(j, n) for n in head), jex, j.centroids,
            j.ivf_table, j.ivf_overflow, k=5, nprobe=NPROBE)
        vectors, xsq, labels, ids = (getattr(t, n) for n in head)
        found = tg.ivf_gather_search(
            tpp, vectors, xsq, ids, tex, t.centroids, t.ivf_table,
            t.ivf_overflow, 5, nprobe=NPROBE)
        got = tg._gathered_to_neighbors(vectors, labels, *found)
    else:
        kw = dict(k=5, nprobe=NPROBE, budget=t.chunk_budget(NPROBE),
                  n_valid=t.ntotal)
        want = jp.retrieve_on_device_ivf_gather_chunked(
            jq, *(getattr(j, n) for n in head), jex, j.centroids,
            j.ivf_chunk_rows, j.ivf_cell_chunks, j.cells, **kw)
        got = tg.retrieve_on_device_ivf_gather_chunked(
            tpp, *(getattr(t, n) for n in head), tex, t.centroids,
            t.ivf_chunk_rows, t.ivf_cell_chunks, t.cells, **kw)
        assert got[4] is False
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the expanded distance |q|^2 - 2 q.x + |x|^2 of near neighbors is a
    # difference of terms ~100x larger: 1e-5 relative plus the f32
    # rounding of those terms, 2^-21 (|q|^2 + max |x|^2), twice
    qsq = tpp.double().square().sum(-1).numpy()
    xmax = float(t.norms_sq[: t.ntotal].max())
    np.testing.assert_array_less(
        np.abs(got[2].numpy() - np.asarray(want[2])),
        1e-5 * np.abs(np.asarray(want[2]))
        + 2.0 * 2.0 ** -21 * (qsq + xmax)[:, None])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_ivf_train_steps_match_jax(ivf_pipes):
    """Two train steps (B = 8, batch exclusion) on the JAX package's IVF DB:
    both packages retrieve unprobed over every row, as JAX's dispatch does
    outside predict; neighbors, loss, gradients and the update agree."""
    jpipe, tpipe, splits = ivf_pipes
    gathers = tpipe.index.ivf_gather_searches
    hold_two_train_steps(jpipe, tpipe, splits["train"], "IVF")
    assert tpipe.index.ivf_gather_searches == gathers


def test_cli_ivf_flags_and_server_nprobe(synthetic_dataset, tmp_path, rng):
    """The CLI's --index_type IVF --nprobe --ivf_balance
    --ivf_no_retrain_on_add map to the JAX CLI's config fields; train
    builds and saves an IVF DB with them, which the JAX package loads and
    searches as the port does (both routes); evaluate, predict and
    build_db run; the server's --nprobe overrides the saved probe count."""
    from radad_tpu import cli as jcli
    from radad_tpu_torch import cli
    from radad_tpu_torch.models.wav2vec2 import Wav2Vec2Config as TW
    from radad_tpu_torch.serve import app

    from test_torch_encoder import TINY, _fake_hf_state_dict

    root = str(tmp_path / "run")
    flags = ["--data_path", synthetic_dataset, "--data_root", root,
             "--index_type", "ivf", "--nprobe", "3", "--ivf_balance", "0.5",
             "--ivf_no_retrain_on_add"]
    tcfg = cli.config_from_args(cli.build_parser().parse_args(
        ["--mode", "train", "--device", "cpu"] + flags))
    jcfg = jcli.config_from_args(jcli.build_parser().parse_args(
        ["--mode", "train"] + flags))
    for name in ("vector_db_index_type", "vector_db_nprobe",
                 "vector_db_ivf_balance", "vector_db_ivf_retrain_on_add",
                 "vector_db_nlist", "vector_db_path"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert (tcfg.vector_db_index_type, tcfg.vector_db_nprobe,
            tcfg.vector_db_ivf_retrain_on_add) == ("IVF", 3, False)

    ckdir = os.path.join(root, "weights", "org--tiny")
    os.makedirs(ckdir)
    sd = _fake_hf_state_dict(rng, TW(**TINY))
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               os.path.join(ckdir, "pytorch_model.bin"))
    with open(os.path.join(ckdir, "config.json"), "w") as f:
        json.dump({k: list(v) if isinstance(v, tuple) else v
                   for k, v in TINY.items()}, f)
    common = ["--device", "cpu", "--model_name", "org/tiny", "--batch_size",
              "8", "--eval_batch_size", "8", "--db_batch_size", "8",
              "--epochs", "1"] + flags
    assert cli.main(["--mode", "train"] + common) == 0
    vdb = os.path.join(root, "vector_db")
    with open(os.path.join(vdb, "index_meta.json")) as f:
        meta = json.load(f)
    assert (meta["metric"], meta["nprobe"], meta["ivf_balance"],
            meta["ivf_retrain_on_add"]) == ("IVF", 3, 0.5, False)
    assert cli.main(["--mode", "evaluate"] + common) == 0
    clip = os.path.join(synthetic_dataset, "clip_000.wav")
    assert cli.main(["--mode", "predict", "--audio_path", clip]
                    + common) == 0
    assert cli.main(["--mode", "build_db"] + common) == 0

    jidx = jflat.FlatIndex.load(vdb)
    tidx = tflat.FlatIndex.load(vdb, device="cpu")
    assert tidx.nlist_effective == jidx.nlist_effective == tidx.ntotal
    # queries a unit of noise away from rows 0 .. 3, which they exclude
    rows = np.asarray(jidx.reconstruct_batch(np.arange(4)))
    q = (rows + rng.standard_normal(rows.shape)).astype(np.float32)
    _assert_probe_margins(q, tidx.centroids.numpy(), 3)
    ids = np.asarray(jidx.ids)[:4]
    for gather in (True, False):
        kw = dict(exclude_ids=ids, gather=gather)
        _assert_same(tidx.search(q, 3, **kw), jidx.search(q, 3, **kw))

    args = app.build_parser().parse_args(
        ["--data_path", synthetic_dataset, "--data_root", root, "--device",
         "cpu", "--model_name", "org/tiny", "--nprobe", "7"])
    cfg = app.config_from_args(args)
    assert cfg.vector_db_nprobe == 7
    httpd = app.serve(cfg, host="127.0.0.1", port=0, device="cpu",
                      nprobe=args.nprobe)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert app.Handler.state.pipeline.index.nprobe == 7
        assert app.Handler.state.pipeline.index.metric == "IVF"
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
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
