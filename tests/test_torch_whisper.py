"""The port's Whisper encoder against the JAX package's on the CPU: the
log-mel frontend, the encoder in both pad modes (the 30 s parity default
and ``whisper_pad_seconds=None``) in f32 and bf16, the HF and JAX weight
converters, the registry, ``DetectionPipeline``, the CLI and the server.
Each test gives both packages the same seeded numpy inputs, and the same
weights through ``models/convert.py::whisper_from_jax``."""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.models import hf_convert as jhf
from radad_tpu.models import whisper as jw
from radad_tpu.models.encoder import FrozenEncoder as JEnc
from radad_tpu.models.encoder import resolve_arch_config as j_resolve
from radad_tpu.ops import melspec as jmel
from radad_tpu_torch.models import encoder_common as TC
from radad_tpu_torch.models import hf_convert as thf
from radad_tpu_torch.models import whisper as tw
from radad_tpu_torch.models.convert import fusion_from_flax, whisper_from_jax
from radad_tpu_torch.models.encoder import FrozenEncoder as TEnc
from radad_tpu_torch.models.encoder import build_encoder, resolve_arch_config
from radad_tpu_torch.ops import melspec as tmel

from test_torch_mixed_precision import _rel
from test_torch_pipeline import _cfg_kwargs

# head width 16: a width fused_mha is built for (tests/test_torch_cuda.py
# runs the same encoder on the card)
TINY = dict(d_model=64, num_hidden_layers=2, num_attention_heads=4,
            ffn_dim=128)
PADS = [30.0, None]


def _waves(rng, *shape):
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------------ log-mel
def test_mel_filter_bank_equals_jax():
    """The port's copy of the filter bank and window: JAX's numbers to the
    last bit (the same numpy), 80 and 128 bins."""
    for bins in (80, 128):
        np.testing.assert_array_equal(tmel.mel_filter_bank(201, bins),
                                      jmel.mel_filter_bank(201, bins))
    np.testing.assert_array_equal(tmel._hann_window(400),
                                  jmel._hann_window(400))


@pytest.mark.parametrize("seconds,bins", [(2, 80), (30, 80), (2, 128),
                                          (30, 128)])
def test_log_mel_matches_jax(seconds, bins, rng):
    """Log-mel of seeded waves within 5e-5 of JAX's (two f32 FFTs and f32
    mel sums in other orders; the floor at max - 8 is the same), on
    leading batch dims ``[2, 2, L]``."""
    wave = _waves(rng, 2, 2, 16000 * seconds)
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wave),
                                               num_mel=bins))
    got = tmel.log_mel_spectrogram(torch.as_tensor(wave), num_mel=bins)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, 2, 100 * seconds, bins)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)


# ----------------------------------------------------------- tiny encoders
@pytest.fixture(scope="module")
def tiny():
    """A seeded tiny JAX Whisper (80 mel bins, 1,500 positions) and the
    port's with the same weights."""
    params = jw.init_params(jax.random.PRNGKey(1), jw.WhisperConfig(**TINY))
    model = whisper_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             tw.WhisperConfig(**TINY))
    return params, model


def _encoders(params, model, pad, jdt=jnp.float32, tdt=torch.float32):
    jenc = JEnc(name="whisper", model_name="tiny",
                arch_cfg=jw.WhisperConfig(**TINY), params=params,
                pretrained=False, compute_dtype=jdt, whisper_pad_seconds=pad)
    # input_normalize is never applied to Whisper (its input is the mel)
    tenc = TEnc(name="whisper", model_name="tiny",
                arch_cfg=tw.WhisperConfig(**TINY), model=model,
                pretrained=False, input_normalize=True, compute_dtype=tdt,
                whisper_pad_seconds=pad)
    return jenc, tenc


@pytest.mark.parametrize("pad", PADS)
def test_whisper_features_match_jax(tiny, pad):
    """``segment_features`` of 2 x 2 two-second windows in f32: within
    atol 2e-5 / rtol 1e-4 of JAX's (the tolerance of the JAX encoder
    against HF, tests/test_encoders.py), 1,500 frames padded to 30 s and
    100 frames trimmed; ``frames_per_segment`` says so."""
    params, model = tiny
    jenc, tenc = _encoders(params, model, pad)
    segs = _waves(np.random.default_rng(5), 2, 2, 32000)
    want = np.asarray(jenc.segment_features(params, jnp.asarray(segs)))
    got = tenc.segment_features(torch.as_tensor(segs))
    frames = 1500 if pad else 100
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, 2, frames, 64)
    assert tenc.frames_per_segment(32000) == frames
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def bf16_features(tiny):
    """{pad: {"jax_f32", "jax_bf16"}} of the tiny encoder on 3 seeded
    two-second windows, JAX op by op (``jax.disable_jit``: every bf16 op
    rounds where the JAX source writes it, the rounding points the port
    mirrors; tests/test_torch_mixed_precision.py), and the windows."""
    params, model = tiny
    segs = _waves(np.random.default_rng(7), 3, 32000)
    out = {}
    for pad in PADS:
        out[pad] = {}
        for name, jdt in (("jax_f32", jnp.float32), ("jax_bf16", jnp.bfloat16)):
            jenc, _ = _encoders(params, model, pad, jdt=jdt)
            with jax.disable_jit():
                out[pad][name] = np.asarray(jenc.segment_features(
                    params, jnp.asarray(segs)))
    return out, segs


def _port_ratio(tiny, bf16_features, pad):
    """(relative distance of the port's bf16 features from JAX's bf16 ones
    over JAX's bf16-to-f32 distance, the port's f32 distance from JAX's)."""
    params, model = tiny
    out, segs = bf16_features
    f32 = _encoders(params, model, pad)[1].segment_features(
        torch.as_tensor(segs))
    bf16 = _encoders(params, model, pad, tdt=torch.bfloat16)[
        1].segment_features(torch.as_tensor(segs))
    assert bf16.dtype == torch.float32
    noise = _rel(out[pad]["jax_bf16"], out[pad]["jax_f32"])
    return _rel(bf16, out[pad]["jax_bf16"]) / noise, _rel(
        f32, out[pad]["jax_f32"])


@pytest.mark.parametrize("pad", PADS)
def test_whisper_bf16_rounds_where_jax_rounds(tiny, bf16_features, pad):
    """bf16 (the mel rounded before conv1, pos_embed cast, the tanh GELU op
    by op, f32 out): the port's features lie within half of JAX's
    bf16-to-f32 distance of JAX's bf16 features (measured 0.26 padded,
    0.27 trimmed: f32 FFT and mel sums in another order move a bf16
    rounding of the conv input here and there); f32 within 1e-5 relative
    (measured 2e-7)."""
    ratio, f32_rel = _port_ratio(tiny, bf16_features, pad)
    assert f32_rel < 1e-5
    assert ratio <= 0.5, (pad, ratio)


@pytest.mark.parametrize("pad", PADS)
def test_whisper_bf16_ratio_control_fails(tiny, bf16_features, pad,
                                          monkeypatch):
    """The check bites: the port with the exact GELU in bf16 misses it
    (measured ratio 0.94 padded, 0.92 trimmed)."""
    monkeypatch.setattr(TC, "gelu", lambda x: torch.nn.functional.gelu(x))
    ratio, _ = _port_ratio(tiny, bf16_features, pad)
    assert ratio > 0.5, (pad, ratio)


# -------------------------------------------------------------- converters
def _fake_hf_state_dict(rng, cfg, prefix="encoder."):
    """Random HF WhisperModel-style encoder state dict (torch layouts, no
    k_proj bias), keys under ``prefix``."""
    def r(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    d, f = cfg.d_model, cfg.ffn_dim
    sd = {"conv1.weight": r(d, cfg.num_mel_bins, 3), "conv1.bias": r(d),
          "conv2.weight": r(d, d, 3), "conv2.bias": r(d),
          "embed_positions.weight": r(cfg.max_source_positions, d),
          "layer_norm.weight": 1 + r(d), "layer_norm.bias": r(d)}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}"
        for hf in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.self_attn.{hf}.weight"] = r(d, d)
            if hf != "k_proj":
                sd[f"{p}.self_attn.{hf}.bias"] = r(d)
        for hf in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{p}.{hf}.weight"] = 1 + r(d)
            sd[f"{p}.{hf}.bias"] = r(d)
        sd[f"{p}.fc1.weight"], sd[f"{p}.fc1.bias"] = r(f, d), r(f)
        sd[f"{p}.fc2.weight"], sd[f"{p}.fc2.bias"] = r(d, f), r(d)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["model.encoder.", "encoder.", ""])
def test_convert_whisper_encoder_matches_jax(prefix, rng):
    """One HF state dict (each key prefix a checkpoint may carry) through
    both packages' ``convert_whisper_encoder``: the same features in the
    trimmed mode."""
    sd = _fake_hf_state_dict(rng, tw.WhisperConfig(**TINY), prefix)
    params = jhf.convert_whisper_encoder(sd, jw.WhisperConfig(**TINY))
    model = thf.convert_whisper_encoder(
        {k: torch.as_tensor(v) for k, v in sd.items()},
        tw.WhisperConfig(**TINY))
    assert "kb" not in model.layers[0]["attn"]
    segs = _waves(rng, 2, 32000)
    want = np.asarray(jw.extract_features(params, jnp.asarray(segs),
                                          jw.WhisperConfig(**TINY),
                                          pad_to_seconds=None))
    got = tw.extract_features(model, torch.as_tensor(segs), None).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    with pytest.raises(KeyError):
        thf.convert_whisper_encoder({"decoder.conv1.weight": 0},
                                    tw.WhisperConfig(**TINY))


def test_convert_hf_whisper_model_matches_jax_and_hf():
    """A tiny ``transformers.WhisperModel`` (80 mel bins, 1,500 positions):
    its state dict through both packages' converters; the port's encoder,
    JAX's and HF's own give the same last hidden state on one 3,000-frame
    mel."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.WhisperConfig(
        d_model=64, encoder_layers=2, encoder_attention_heads=4,
        encoder_ffn_dim=128, num_mel_bins=80, max_source_positions=1500,
        decoder_layers=1, decoder_attention_heads=4, decoder_ffn_dim=64,
        attn_implementation="eager")
    torch.manual_seed(0)
    tm = transformers.WhisperModel(hf).eval()
    sd = tm.state_dict()
    params = jhf.convert_whisper_encoder(sd, jw.WhisperConfig(**TINY))
    model = thf.convert_whisper_encoder(sd, tw.WhisperConfig(**TINY))
    mel = np.random.default_rng(2).standard_normal((2, 80, 3000)).astype(
        np.float32)
    with torch.no_grad():
        want = tm.encoder(torch.as_tensor(mel)).last_hidden_state.numpy()
    got = tw.encode_mel(model, torch.as_tensor(mel).transpose(1, 2)).numpy()
    jgot = np.asarray(jw.encode_mel(params, jnp.asarray(
        mel.transpose(0, 2, 1)), jw.WhisperConfig(**TINY)))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, jgot, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------- registry
def test_build_encoder_whisper_random(tmp_path):
    """No checkpoint → seeded random whisper-base at full width (same seed,
    same weights), 512 features a frame, 1,500 frames per 2 s window padded
    to 30 s and 100 trimmed; the trimmed forward gives them."""
    from radad_tpu_torch.config import Config

    cfg = Config().replace(data_root=str(tmp_path),
                           feature_extractor_type="whisper")
    a = build_encoder(cfg, device="cpu", seed=3)
    b = build_encoder(cfg, device="cpu", seed=3)
    assert a.name == "whisper" and not a.pretrained
    assert a.arch_cfg == tw.WhisperConfig() and a.feature_dim == 512
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
    np.testing.assert_array_equal(
        a.model.pos_embed.numpy(), np.asarray(jw.init_params(
            jax.random.PRNGKey(0), jw.WhisperConfig())["pos_embed"]))
    assert a.whisper_pad_seconds == 30.0
    assert a.frames_per_segment(32000) == 1500
    fast = build_encoder(cfg.replace(whisper_pad_seconds=None), device="cpu")
    assert fast.frames_per_segment(32000) == 100
    feats = fast.segment_features(torch.as_tensor(
        _waves(np.random.default_rng(0), 1, 32000)))
    assert feats.shape == (1, 100, 512) and torch.isfinite(feats).all()


@pytest.mark.parametrize("name", ["whisper-tiny", "whisper-base",
                                  "whisper-small", "whisper-medium",
                                  "whisper-large", "whisper-large-v2",
                                  "whisper-large-v3"])
def test_whisper_presets_match_jax(name):
    """Every Whisper preset resolves to the JAX package's architecture
    (large-v3: 128 mel bins); every one has head width 64."""
    got = resolve_arch_config(f"openai/{name}", kind="whisper")
    want = j_resolve("whisper", f"openai/{name}")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.d_model // got.num_attention_heads == 64
    assert got.num_mel_bins == (128 if name == "whisper-large-v3" else 80)


def _write_checkpoint(rng, root, name, cfg):
    """A fake HF Whisper checkpoint and its config.json (HF's key names)
    under ``root/name``. → the state dict."""
    ckdir = os.path.join(root, name)
    os.makedirs(ckdir)
    sd = _fake_hf_state_dict(rng, cfg, "model.encoder.")
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               os.path.join(ckdir, "pytorch_model.bin"))
    with open(os.path.join(ckdir, "config.json"), "w") as f:
        json.dump({"d_model": cfg.d_model,
                   "encoder_layers": cfg.num_hidden_layers,
                   "encoder_attention_heads": cfg.num_attention_heads,
                   "encoder_ffn_dim": cfg.ffn_dim,
                   "num_mel_bins": cfg.num_mel_bins,
                   "max_source_positions": cfg.max_source_positions,
                   "decoder_layers": 1, "vocab_size": 51865}, f)
    return sd


def test_build_encoder_whisper_local_checkpoint(tmp_path, rng):
    """A local checkpoint with its config.json (HF's names: encoder_layers,
    encoder_attention_heads, encoder_ffn_dim, ...) loads with JAX's
    renames, as the JAX package reads it."""
    from radad_tpu_torch.config import Config

    arch = tw.WhisperConfig(d_model=64, num_hidden_layers=3,
                            num_attention_heads=4, ffn_dim=96,
                            num_mel_bins=128, max_source_positions=1500)
    sd = _write_checkpoint(rng, str(tmp_path / "weights"),
                           "org--tiny-whisper", arch)
    cfg = Config().replace(data_root=str(tmp_path),
                           feature_extractor_type="whisper",
                           whisper_model_name="org/tiny-whisper")
    enc = build_encoder(cfg, device="cpu")
    assert enc.pretrained and enc.arch_cfg == arch
    ckpt = str(tmp_path / "weights" / "org--tiny-whisper" / "pytorch_model.bin")
    assert dataclasses.asdict(enc.arch_cfg) == dataclasses.asdict(
        j_resolve("whisper", "org/tiny-whisper", ckpt))
    torch.testing.assert_close(
        enc.model.layers[2]["ffn"]["w2"],
        torch.as_tensor(sd["model.encoder.layers.2.fc2.weight"]))
    feats = enc.segment_features(torch.as_tensor(_waves(rng, 2, 32000)))
    assert feats.shape == (2, 1500, 64) and torch.isfinite(feats).all()


# --------------------------------------------------------------- pipelines
@pytest.fixture(scope="module", params=PADS, ids=["pad30", "trimmed"])
def pair(request, tiny, tmp_path_factory, synthetic_dataset):
    """A JAX pipeline and a port pipeline with the same tiny Whisper and
    fusion weights in one pad mode, each with its DB built from the same
    training split."""
    from radad_tpu.config import Config as JConfig
    from radad_tpu.data.manifest import load_manifests
    from radad_tpu.train.pipeline import DetectionPipeline as JPipe
    from radad_tpu_torch.config import Config as TConfig
    from radad_tpu_torch.train.pipeline import DetectionPipeline as TPipe

    pad = request.param
    params, model = tiny
    jenc, tenc = _encoders(params, model, pad)
    over = dict(feature_extractor_type="whisper", whisper_pad_seconds=pad)
    splits = load_manifests(synthetic_dataset)
    jroot = str(tmp_path_factory.mktemp("jax_whisper"))
    troot = str(tmp_path_factory.mktemp("torch_whisper"))
    jpipe = JPipe(JConfig().replace(**_cfg_kwargs(jroot), **over),
                  encoder=jenc)
    jpipe._ensure_model_state()
    jpipe.build_vector_database(splits["train"])
    tpipe = TPipe(TConfig().replace(**_cfg_kwargs(troot), **over),
                  encoder=tenc, device="cpu")
    fusion_from_flax(tpipe.model, jax.tree_util.tree_map(
        np.asarray, jpipe.variables))
    tpipe.build_vector_database(splits["train"])
    return jpipe, tpipe, splits


def _held_to_f64(tpipe, paths, outs, distances=True):
    """The neighbors of ``outs`` (a predict_batch result on ``paths``, each
    row excluding its own file) against an f64 scan of the port's own
    embeddings: at every rank the f64 squared distance of the returned
    neighbor equals the f64 top-k's within f32 rounding of the expanded
    score the search takes, 2^-21 (|q|^2 + max |x|^2) (chip_smoke.py's
    rule), and (``distances``) so does the distance returned for it."""
    from radad_tpu_torch.data.audio import load_audio
    from radad_tpu_torch.data.manifest import file_id

    cfg, ix = tpipe.config, tpipe.index
    waves = np.stack([load_audio(p, sample_rate=cfg.sample_rate,
                                 duration=cfg.clip_duration) for p in paths])
    q = tpipe._embed(torch.as_tensor(waves)).double()
    x = ix.vectors[: ix.ntotal].double()
    d64 = (q[:, None, :] - x[None]).square().sum(-1)
    own = torch.as_tensor([file_id(p) for p in paths])
    d64 = d64.masked_fill(ix.ids[: ix.ntotal][None, :] == own[:, None],
                          float("inf"))
    ref_d, ref = d64.topk(cfg.top_k, largest=False)
    row = {os.path.basename(p): i for i, p in enumerate(ix.paths)}
    got = torch.as_tensor([[row[f] for f in o["retrieved_files"]]
                           for o in outs])
    tol = 2.0 ** -21 * (q.square().sum(-1) + x.square().sum(-1).max())
    excess = (d64.gather(1, got).sort(-1).values - ref_d).abs() - tol[:, None]
    assert float(excess.max()) <= 0, float(excess.max())
    if not distances:
        return
    returned = torch.as_tensor([[r["distance"] for r in o["retrieved"]]
                                for o in outs], dtype=torch.float64)
    excess = (returned - d64.gather(1, got)).abs() - tol[:, None]
    assert float(excess.max()) <= 0, float(excess.max())


def test_whisper_pipeline_matches_jax(pair):
    """build_db + predict_batch with Whisper in each pad mode: TPP width
    7 x 64, DB embeddings within the wav2vec2 pipeline test's tolerance,
    logits within 1e-4 of JAX's (val and train clips; train clips exclude
    their own file). Trimmed: neighbor ids equal JAX's, distances within
    rtol 1e-4 / atol 1e-3, as the wav2vec2 pipeline test. Padded to 30 s,
    the clips' embeddings are mostly the same padding frames: squared
    distances of ~0.03 beside |x|^2 of ~4,000, so the f32 expanded score
    |q|^2 - 2 q.x + |x|^2 that both packages return carries rounding of
    ~1e-3 and orders neighbors that close by it (measured: 5 of 8 rows
    swap such a pair, one returned distance 1.1e-3 from JAX's). There both
    packages' neighbors are held to the f64 scan of the port's embeddings
    within f32 rounding of that score, 2^-21 (|q|^2 + max |x|^2), as
    chip_smoke.py holds the card's, and so are the distances the port
    returns (JAX's, from its own embeddings and GEMM, lie up to 2.0e-3
    off)."""
    jpipe, tpipe, splits = pair
    assert tpipe.tpp_dim == 7 * 64
    jv = np.asarray(jpipe.index.vectors)[: jpipe.index.ntotal]
    tv = tpipe.index.vectors[: tpipe.index.ntotal].numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=5e-4)
    paths = list(splits["val"].paths[:5]) + list(splits["train"].paths[:3])
    jout = jpipe.predict_batch(paths)
    tout = tpipe.predict_batch(paths)
    trimmed = tpipe.encoder.whisper_pad_seconds is None
    if not trimmed:
        _held_to_f64(tpipe, paths, tout)
        _held_to_f64(tpipe, paths, jout, distances=False)
    for path, j, t in zip(paths, jout, tout):
        assert abs(t["logit"] - j["logit"]) < 1e-4, path
        if trimmed:
            assert t["retrieved_files"] == j["retrieved_files"], path
            np.testing.assert_allclose(
                [r["distance"] for r in t["retrieved"]],
                [r["distance"] for r in j["retrieved"]], rtol=1e-4,
                atol=1e-3)
        assert t["prediction"] == j["prediction"]
        assert os.path.basename(path) not in t["retrieved_files"]
    assert tpipe.index.fallbacks == 0


def test_whisper_server_predict(pair, synthetic_dataset):
    """The port's server answers one /api/predict upload with Whisper."""
    from radad_tpu_torch.serve.app import serve

    _, tpipe, splits = pair
    httpd = serve(tpipe.config.replace(train_data_path=synthetic_dataset),
                  host="127.0.0.1", port=0, pipeline=tpipe)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with open(splits["val"].paths[0], "rb") as f:
            wav = f.read()
        boundary = "radadwhisperboundary"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f"name=\"file\"; filename=\"up.wav\"\r\nContent-Type: "
                f"audio/wav\r\n\r\n").encode() + wav + \
            f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/predict",
            data=body, method="POST", headers={
                "Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            out = json.loads(resp.read())
        assert out["ok"] and out["prediction"] in ("spoof", "bona-fide")
        assert len(out["neighbors"]) == tpipe.config.top_k
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


# -------------------------------------------------------------- CLI, train
def test_whisper_cli_and_server_flags():
    """--feature_extractor whisper --whisper_fast → whisper_pad_seconds
    None, --model_name names the Whisper checkpoint; the parity default
    stays 30 s (the JAX CLI's mapping, tests/test_cli_serve.py)."""
    from radad_tpu_torch import cli
    from radad_tpu_torch.serve import app

    args = ["--feature_extractor", "whisper", "--whisper_fast",
            "--model_name", "openai/whisper-small"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["--mode", "train"] + args))
    assert cfg.feature_extractor_type == "whisper"
    assert cfg.whisper_pad_seconds is None
    assert cfg.whisper_model_name == "openai/whisper-small"
    scfg = app.config_from_args(app.build_parser().parse_args(
        ["--data_path", "d"] + args))
    assert scfg.whisper_pad_seconds is None
    assert scfg.whisper_model_name == "openai/whisper-small"
    for parser, extra in ((cli.build_parser(), ["--mode", "train"]),
                          (app.build_parser(), ["--data_path", "d"])):
        mod = cli if extra[0] == "--mode" else app
        assert mod.config_from_args(parser.parse_args(
            extra)).whisper_pad_seconds == 30.0


def test_whisper_cli_train(synthetic_dataset, tmp_path, rng):
    """One epoch of ``--mode train --feature_extractor whisper
    --whisper_fast --device cpu`` on a tiny local Whisper checkpoint
    writes metrics.csv; the trainer embeds through the same encoder."""
    from radad_tpu_torch import cli

    _write_checkpoint(rng, str(tmp_path / "weights"), "org--tiny-whisper",
                      tw.WhisperConfig(**TINY))
    root = str(tmp_path / "run")
    assert cli.main([
        "--mode", "train", "--device", "cpu", "--epochs", "1",
        "--feature_extractor", "whisper", "--whisper_fast",
        "--model_name", "org/tiny-whisper",
        "--weights_dir", str(tmp_path / "weights"),
        "--data_path", synthetic_dataset, "--data_root", root,
        "--batch_size", "8", "--eval_batch_size", "8"]) == 0
    with open(os.path.join(root, "metrics.csv")) as f:
        rows = f.read().strip().splitlines()
    assert len(rows) >= 2 and "train_loss" in rows[0]

