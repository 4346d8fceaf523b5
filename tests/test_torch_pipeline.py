"""Port (radad_tpu_torch) serving path against the JAX package, on the CPU:
DB build + predict_batch with the same WAVs and weights, the import
boundary, the device rule of the entry points, checkpoints and the HTTP
server."""

import os
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from radad_tpu.config import Config as JConfig
from radad_tpu.data.manifest import load_manifests

from test_torch_encoder import TINY, _fake_hf_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg_kwargs(root):
    return dict(data_root=root, vector_db_path=os.path.join(root, "vdb"),
                db_batch_size=8, use_layer_norm=True, use_batch_norm=False)


@pytest.fixture(scope="module")
def pair(tmp_path_factory, synthetic_dataset):
    """A JAX pipeline and a port pipeline with the same encoder and fusion
    weights, each with its DB built from the same training split."""
    from radad_tpu.models.encoder import FrozenEncoder as JEnc
    from radad_tpu.models.wav2vec2 import Wav2Vec2Config as JW, init_params
    from radad_tpu.train.pipeline import DetectionPipeline as JPipe
    from radad_tpu_torch.config import Config as TConfig
    from radad_tpu_torch.models.convert import (encoder_from_jax,
                                                fusion_from_flax)
    from radad_tpu_torch.models.encoder import FrozenEncoder as TEnc
    from radad_tpu_torch.models.wav2vec2 import Wav2Vec2Config as TW
    from radad_tpu_torch.train.pipeline import DetectionPipeline as TPipe

    params = init_params(jax.random.PRNGKey(0), JW(**TINY))
    jenc = JEnc(name="wav2vec2", model_name="tiny", arch_cfg=JW(**TINY),
                params=params, pretrained=False, layers_to_use=(-2, -1))
    tenc = TEnc(name="wav2vec2", model_name="tiny", arch_cfg=TW(**TINY),
                model=encoder_from_jax(jax.tree_util.tree_map(
                    np.asarray, params), TW(**TINY)),
                pretrained=False, layers_to_use=(-2, -1))
    jroot = str(tmp_path_factory.mktemp("jax_run"))
    troot = str(tmp_path_factory.mktemp("torch_run"))
    splits = load_manifests(synthetic_dataset)
    jpipe = JPipe(JConfig().replace(**_cfg_kwargs(jroot)), encoder=jenc)
    jpipe._ensure_model_state()
    jpipe.build_vector_database(splits["train"])
    tpipe = TPipe(TConfig().replace(**_cfg_kwargs(troot)), encoder=tenc,
                  device="cpu")
    fusion_from_flax(tpipe.model, jax.tree_util.tree_map(
        np.asarray, jpipe.variables))
    tpipe.build_vector_database(splits["train"])
    return jpipe, tpipe, splits


def test_db_embeddings_match(pair):
    jpipe, tpipe, _ = pair
    jv = np.asarray(jpipe.index.vectors)[: jpipe.index.ntotal]
    tv = tpipe.index.vectors[: tpipe.index.ntotal].numpy()
    # f32 conv/matmul summation order differs between XLA and PyTorch on
    # the CPU; seen up to 1.7e-4 on entries of size ~2
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=5e-4)
    assert tpipe.index.paths == jpipe.index.paths
    np.testing.assert_array_equal(tpipe.index.ids[: tpipe.index.ntotal],
                                  np.asarray(jpipe.index.ids)[
                                      : jpipe.index.ntotal])


@pytest.mark.parametrize("split", ["val", "train"])
def test_predict_batch_matches_jax(pair, split):
    """Identical neighbor ids, logits within 1e-4 (val clips; train clips
    exercise per-row self exclusion)."""
    jpipe, tpipe, splits = pair
    paths = list(splits[split].paths[:5])
    jout = jpipe.predict_batch(paths)
    tout = tpipe.predict_batch(paths)
    for path, j, t in zip(paths, jout, tout):
        assert t["retrieved_files"] == j["retrieved_files"], path
        assert abs(t["logit"] - j["logit"]) < 1e-4, path
        np.testing.assert_allclose(
            [r["distance"] for r in t["retrieved"]],
            [r["distance"] for r in j["retrieved"]], rtol=1e-4, atol=1e-3)
        assert t["prediction"] == j["prediction"]
        assert set(t["stage_ms"]) == {"decode", "device", "payload", "batch"}
        assert os.path.basename(path) not in t["retrieved_files"]
    assert tpipe.index.fallbacks == 0


def test_predict_single_matches_jax(pair):
    jpipe, tpipe, splits = pair
    path = splits["val"].paths[0]
    j, t = jpipe.predict(path), tpipe.predict(path)
    assert t["retrieved_files"] == j["retrieved_files"]
    assert abs(t["logit"] - j["logit"]) < 1e-4
    assert set(t) == set(j)


def test_predict_batch_per_row_wipe_retry(pair):
    """A row whose neighbors are all excluded retries without exclusion;
    the other row keeps its first-pass neighbors."""
    from radad_tpu_torch.data.manifest import file_id
    from radad_tpu_torch.index.flat import FlatIndex

    _, tpipe, splits = pair
    src, other = splits["train"].paths[0], splits["train"].paths[1]
    emb = tpipe.get_embeddings(splits["train"])
    one = FlatIndex(tpipe.tpp_dim, "L2", device="cpu")
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


def _serial_predict_batch(tpipe, paths, max_duration=None):
    """``predict_batch``'s inputs and answers as it made them before it
    decoded on a pool: ``load_audio`` a clip in turn, stacked."""
    from radad_tpu_torch.data.audio import load_audio
    from radad_tpu_torch.data.manifest import file_id

    cfg = tpipe.config
    lengths = None
    if max_duration is None:
        waves = np.stack([load_audio(p, sample_rate=cfg.sample_rate,
                                     duration=cfg.clip_duration)
                          for p in paths])
    else:
        raw = [load_audio(p, sample_rate=cfg.sample_rate,
                          duration=max_duration, pad=False) for p in paths]
        waves = np.zeros((len(raw), tpipe._grid_pad()), np.float32)
        for row, w in enumerate(raw):
            waves[row, :len(w)] = w
        lengths = [max(min(len(w), cfg.analysis_samples), 1) for w in raw]
    logits, nlabels, dists, idx = tpipe._predict_tensors(
        waves, [file_id(p) for p in paths], lengths, "self")
    answers = [tpipe._payload(float(logits[r]), idx[r].tolist(),
                              nlabels[r].tolist(), dists[r].tolist())
               for r in range(len(paths))]
    return waves, lengths, answers


def _recording_inputs(tpipe, monkeypatch):
    """Record a copy of each batch and its lengths ``_predict_tensors``
    is given."""
    seen = []
    inner = tpipe._predict_tensors

    def record(waves, exclude, lengths, mode):
        seen.append((np.array(waves, copy=True), lengths))
        return inner(waves, exclude, lengths, mode)

    monkeypatch.setattr(tpipe, "_predict_tensors", record)
    return seen


def _answer(o):
    return {k: v for k, v in o.items() if k != "stage_ms"}


@pytest.mark.parametrize("max_duration", [None, 2.5])
def test_predict_batch_decode_equals_serial_decode(pair, monkeypatch,
                                                   max_duration):
    """The batch the device path is given, its lengths (the max_duration
    path) and the answers equal those of the serial decode bit for bit;
    the decode's counters count the call."""
    from radad_tpu_torch.data import audio

    _, tpipe, splits = pair
    monkeypatch.setattr(tpipe, "config",
                        tpipe.config.replace(max_duration=max_duration))
    paths = list(splits["val"].paths[:5]) + [splits["train"].paths[0]] * 2
    waves, lengths, want = _serial_predict_batch(tpipe, paths, max_duration)
    seen = _recording_inputs(tpipe, monkeypatch)
    before = dict(vars(audio.decode_counts))
    got = tpipe.predict_batch(paths)
    after = vars(audio.decode_counts)
    (got_waves, got_lengths), = seen
    assert got_waves.dtype == np.float32
    assert got_waves.tobytes() == waves.tobytes()
    assert got_lengths == lengths
    assert [_answer(o) for o in got] == want
    pooled = len(paths) if after["workers"] > 1 else 0
    assert {k: after[k] - before[k] for k in
            ("calls", "clips", "pooled", "pinned")} == {
        "calls": 1, "clips": len(paths), "pooled": pooled, "pinned": 0}
    # a second call of the shape, on other clips, uploads its own clips
    other = list(splits["train"].paths[1:8])
    waves, lengths, want = _serial_predict_batch(tpipe, other, max_duration)
    seen.clear()
    assert [_answer(o) for o in tpipe.predict_batch(other)] == want
    (got_waves, got_lengths), = seen
    assert got_waves.tobytes() == waves.tobytes()
    assert got_lengths == lengths


def test_predict_batch_calls_in_flight_never_share_a_batch(pair,
                                                           monkeypatch):
    """Two threads in ``predict_batch`` at once, each past its decode
    before either reaches the device, on different clips of one batch
    shape: each uploads its own clips and gets its own answers."""
    _, tpipe, splits = pair
    batches = [list(splits["val"].paths[:4]), list(splits["train"].paths[:4])]
    want = [[_answer(o) for o in tpipe.predict_batch(b)] for b in batches]
    inputs = [_serial_predict_batch(tpipe, b)[0].tobytes() for b in batches]
    both = threading.Barrier(2, timeout=60)
    inner = tpipe._predict_tensors
    given = {}

    def meet(waves, exclude, *a):
        both.wait()  # both decoded, neither on the device yet
        given[tuple(exclude)] = np.array(waves, copy=True).tobytes()
        return inner(waves, exclude, *a)

    monkeypatch.setattr(tpipe, "_predict_tensors", meet)
    got = [None, None]

    def call(i):
        got[i] = [_answer(o) for o in tpipe.predict_batch(batches[i])]
    threads = [threading.Thread(target=call, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert got == want
    from radad_tpu_torch.data.manifest import file_id
    assert [given[tuple(file_id(p) for p in b)] for b in batches] == inputs


def test_checkpoint_and_db_roundtrip(pair, tmp_path):
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    _, tpipe, splits = pair
    path = splits["val"].paths[1]
    want = tpipe.predict(path)
    tpipe.save_models("final_model")
    other = DetectionPipeline(tpipe.config, encoder=tpipe.encoder,
                              device="cpu")
    assert other.load_models("final_model")
    assert other.load_vector_database()
    got = other.predict(path)
    assert got["retrieved_files"] == want["retrieved_files"]
    assert got["logit"] == want["logit"]
    assert not other.load_models("missing_prefix")


def test_no_jax_import():
    """Importing every module of the port loads neither JAX nor anything
    of radad_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import radad_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, p.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'radad_tpu')]\n"
        "print(len(mods))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_entry_points_need_a_gpu_unless_cpu(tmp_path, monkeypatch):
    """Without a GPU the pipeline, index, encoder, CLI and server raise
    unless device='cpu' is passed. A mesh (--data_shards 2) in a world of
    one rank raises make_mesh's ValueError before the encoder is built."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from radad_tpu_torch import cli
    from radad_tpu_torch.config import Config
    from radad_tpu_torch.index.flat import FlatIndex
    from radad_tpu_torch.models.encoder import build_encoder
    from radad_tpu_torch.serve.app import serve
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    cfg = Config().replace(data_root=str(tmp_path))
    for call in (lambda: DetectionPipeline(cfg),
                 lambda: FlatIndex(16),
                 lambda: build_encoder(cfg),
                 lambda: serve(cfg, port=0),
                 lambda: cli.main(["--mode", "build_db",
                                   "--data_path", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert FlatIndex(16, device="cpu").device.type == "cpu"
    import socket

    import torch.distributed as dist

    with socket.socket() as s:  # a free port for the world's store
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", port),
                       ("RANK", 0), ("WORLD_SIZE", 1), ("LOCAL_RANK", 0)):
        monkeypatch.setenv(key, str(value))
    with pytest.raises(ValueError, match="mesh 2x1"):
        cli.main(["--mode", "train", "--device", "cpu", "--data_shards",
                  "2"])
    assert not dist.is_initialized()  # the CLI's world is taken down


def test_server_predict(pair, synthetic_dataset):
    """POST a WAV upload to /api/predict and read /api/dbinfo."""
    from radad_tpu_torch.serve.app import serve

    _, tpipe, splits = pair
    httpd = serve(tpipe.config.replace(train_data_path=synthetic_dataset),
                  host="127.0.0.1", port=0, pipeline=tpipe)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with open(splits["val"].paths[0], "rb") as f:
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
            assert resp.status == 200
            import json
            out = json.loads(resp.read())
        assert out["ok"] and out["prediction"] in ("spoof", "bona-fide")
        assert len(out["neighbors"]) == tpipe.config.top_k
        assert {"decode", "device", "queue"} <= set(out["timings_ms"])
        with urllib.request.urlopen(base + "/api/dbinfo", timeout=60) as r:
            info = json.loads(r.read())
        assert info["ntotal"] == tpipe.index.ntotal
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_cli_build_db_and_predict(synthetic_dataset, tmp_path, rng):
    """CLI build_db then predict on the CPU, with a tiny encoder given as a
    local HF checkpoint (config.json beside it)."""
    import json

    from radad_tpu_torch import cli
    from radad_tpu_torch.models.encoder import build_encoder
    from radad_tpu_torch.models.wav2vec2 import Wav2Vec2Config as TW
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    ckdir = tmp_path / "weights" / "org--tiny"
    ckdir.mkdir(parents=True)
    sd = _fake_hf_state_dict(rng, TW(**TINY))
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               ckdir / "pytorch_model.bin")
    with open(ckdir / "config.json", "w") as f:
        json.dump({k: list(v) if isinstance(v, tuple) else v
                   for k, v in TINY.items()}, f)
    root = str(tmp_path / "run")
    common = ["--device", "cpu", "--data_path", synthetic_dataset,
              "--data_root", root, "--weights_dir", str(tmp_path / "weights"),
              "--model_name", "org/tiny"]
    assert cli.main(["--mode", "build_db"] + common) == 0
    assert os.path.exists(os.path.join(root, "vector_db", "index_meta.json"))
    # a second run appends nothing
    assert cli.main(["--mode", "build_db"] + common) == 0
    args = cli.build_parser().parse_args(["--mode", "predict"] + common)
    cfg = cli.config_from_args(args)
    pipe = DetectionPipeline(cfg, device="cpu", encoder=build_encoder(
        cfg, weights_dir=str(tmp_path / "weights"), device="cpu"))
    pipe.save_models("final_model")
    clip = os.path.join(synthetic_dataset, "clip_000.wav")
    assert cli.main(["--mode", "predict", "--audio_path", clip] + common) == 0
    # no checkpoint under the data root: predict fails cleanly
    empty = [a if a != root else str(tmp_path / "empty") for a in common]
    assert cli.main(["--mode", "predict", "--audio_path", clip] + empty) == 1


def test_server_close_releases_the_pipeline(tmp_path):
    """Closing the server stops its micro-batcher thread, and nothing of
    the server keeps the pipeline (and its device memory) alive."""
    import gc
    import weakref

    from radad_tpu_torch.config import Config
    from radad_tpu_torch.serve import app

    class Pipe:
        pass

    pipe = Pipe()
    httpd = app.serve(Config().replace(data_root=str(tmp_path),
                                       train_data_path=str(tmp_path)),
                      host="127.0.0.1", port=0, pipeline=pipe)
    batcher = app.Handler.state.batcher
    assert batcher._thread.is_alive()
    httpd.server_close()
    assert not batcher._thread.is_alive() and batcher.pipeline is None
    assert app.Handler.state is None
    ref = weakref.ref(pipe)
    del pipe
    gc.collect()
    assert ref() is None
