"""Port WavLM encoder and the stable-layer-norm (large) encoder variants
against the JAX package on the CPU (f32): the bucket matrix, features
through the weights bridge (models/convert.py::wavlm_from_jax), the HF
state-dict converter in both packages, and the encoder factory."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.models import hf_convert as jhf
from radad_tpu.models import wavlm as jwavlm
from radad_tpu.models.encoder import FrozenEncoder as JEnc
from radad_tpu.models.wav2vec2 import Wav2Vec2Config as JW
from radad_tpu.models.wav2vec2 import init_params as jw_init
from radad_tpu_torch.models import hf_convert as thf
from radad_tpu_torch.models import wavlm as twavlm
from radad_tpu_torch.models.convert import encoder_from_jax, wavlm_from_jax
from radad_tpu_torch.models.encoder import FrozenEncoder as TEnc
from radad_tpu_torch.models.encoder import build_encoder, resolve_arch_config
from radad_tpu_torch.models.wav2vec2 import Wav2Vec2Config as TW

from test_torch_encoder import _fake_hf_state_dict

TINY_LM = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, conv_dim=(16, 16, 16, 16),
               conv_kernel=(10, 8, 4, 4), conv_stride=(5, 4, 4, 4),
               num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
               num_buckets=32, max_bucket_distance=50)
STABLE = dict(feat_extract_norm="layer", conv_bias=True,
              do_stable_layer_norm=True)


def _perturbed(params, rng, scale=0.05):
    """Every leaf moved off its init value (LN scales and biases, conv
    biases and gate constants included) so each one is checked."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)


def _segments(rng, *shape):
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("t,buckets,dist", [(49, 32, 50), (99, 320, 800),
                                            (1500, 320, 800), (7, 8, 4)])
def test_relative_position_buckets_match_jax(t, buckets, dist):
    got = twavlm.relative_position_buckets(t, buckets, dist)
    want = jwavlm.relative_position_buckets(t, buckets, dist)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("stable", [False, True])
def test_wavlm_features_match_jax(stable, rng):
    """2 layers, 64 wide, 4 heads: post-LN (wavlm-base architecture) and
    pre-LN with the per-layer-LN conv frontend (wavlm-large)."""
    kw = dict(TINY_LM, **(STABLE if stable else {}))
    jcfg, tcfg = jwavlm.WavLMConfig(**kw), twavlm.WavLMConfig(**kw)
    params = _perturbed(jwavlm.init_params(jax.random.PRNGKey(1), jcfg), rng)
    model = wavlm_from_jax(params, tcfg)
    segs = _segments(rng, 3, 16000)
    want = np.asarray(jwavlm.extract_features(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(segs),
        jcfg))
    got = twavlm.extract_features(model, torch.as_tensor(segs)).numpy()
    assert got.shape == want.shape == (3, 49, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the encoder wrapper dispatches on its name, leading dims restored
    jenc = JEnc(name="wavlm", model_name="tiny", arch_cfg=jcfg,
                params=params, pretrained=False)
    tenc = TEnc(name="wavlm", model_name="tiny", arch_cfg=tcfg, model=model,
                pretrained=False)
    segs2 = _segments(rng, 2, 2, 16000)
    np.testing.assert_allclose(
        tenc.segment_features(torch.as_tensor(segs2)).numpy(),
        np.asarray(jenc.segment_features(params, jnp.asarray(segs2))),
        rtol=1e-4, atol=1e-4)


def test_stable_layer_norm_wav2vec2_matches_jax(rng):
    """The lv60/xlsr/HuBERT-large architecture: LN after every conv (with
    conv bias), pre-LN layers, encoder LN after the stack."""
    kw = dict(TINY_LM, **STABLE)
    for key in ("num_buckets", "max_bucket_distance"):
        kw.pop(key)
    kw["hidden_size"], kw["num_hidden_layers"] = 32, 3
    params = _perturbed(jw_init(jax.random.PRNGKey(2), JW(**kw)), rng)
    layers = (-4, -3, -2, -1)
    jenc = JEnc(name="hubert", model_name="tiny", arch_cfg=JW(**kw),
                params=params, pretrained=False, layers_to_use=layers)
    tenc = TEnc(name="hubert", model_name="tiny", arch_cfg=TW(**kw),
                model=encoder_from_jax(params, TW(**kw)), pretrained=False,
                layers_to_use=layers)
    segs = _segments(rng, 2, 16000)
    want = np.asarray(jenc.segment_features(params, jnp.asarray(segs)))
    got = tenc.segment_features(torch.as_tensor(segs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _fake_wavlm_state_dict(rng, cfg):
    """Random HF WavLMModel-style state dict (torch layouts): the wav2vec2
    skeleton, the per-layer gate linear and constant, the bucket table,
    and for the "layer" frontend a conv bias and LN on every conv."""
    def r(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    sd = _fake_hf_state_dict(rng, cfg)
    h = cfg.num_attention_heads
    hd = cfg.hidden_size // h
    sd["encoder.layers.0.attention.rel_attn_embed.weight"] = r(
        cfg.num_buckets, h)
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layers.{i}.attention"
        sd[f"{p}.gru_rel_pos_linear.weight"] = r(8, hd)
        sd[f"{p}.gru_rel_pos_linear.bias"] = r(8)
        sd[f"{p}.gru_rel_pos_const"] = 1 + r(1, h, 1, 1)
    if cfg.feat_extract_norm == "layer":
        for i, c in enumerate(cfg.conv_dim):
            pre = f"feature_extractor.conv_layers.{i}"
            sd[f"{pre}.conv.bias"] = r(c)
            sd[f"{pre}.layer_norm.weight"] = 1 + r(c)
            sd[f"{pre}.layer_norm.bias"] = r(c)
    return sd


@pytest.mark.parametrize("stable", [False, True])
def test_convert_wavlm_matches_jax(stable, rng):
    """One HF state dict through both converters gives the same
    features."""
    kw = dict(TINY_LM, **(STABLE if stable else {}))
    jcfg, tcfg = jwavlm.WavLMConfig(**kw), twavlm.WavLMConfig(**kw)
    sd = _fake_wavlm_state_dict(rng, tcfg)
    params = jhf.convert_wavlm(sd, jcfg)
    model = thf.convert_wavlm({k: torch.as_tensor(v) for k, v in sd.items()},
                              tcfg)
    torch.testing.assert_close(
        model.layers[1]["gate"]["const"],
        torch.as_tensor(sd["encoder.layers.1.attention.gru_rel_pos_const"]
                        ).reshape(-1))
    segs = _segments(rng, 2, 16000)
    want = np.asarray(jwavlm.extract_features(params, jnp.asarray(segs),
                                              jcfg))
    got = twavlm.extract_features(model, torch.as_tensor(segs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_build_encoder_wavlm_random_and_local(tmp_path, rng):
    """No checkpoint → seeded random wavlm-base at full width (same seed,
    same weights); a local checkpoint + config.json (bucket fields
    included) is loaded; presets follow the JAX package's."""
    from radad_tpu_torch.config import Config

    assert resolve_arch_config("microsoft/wavlm-base", kind="wavlm") == \
        twavlm.WavLMConfig()
    large = resolve_arch_config("microsoft/wavlm-large", kind="wavlm")
    assert (large.hidden_size, large.num_hidden_layers,
            large.do_stable_layer_norm, large.feat_extract_norm) == \
        (1024, 24, True, "layer")
    lv60 = resolve_arch_config("facebook/wav2vec2-large-960h-lv60-self")
    assert lv60.do_stable_layer_norm and lv60.conv_bias
    assert resolve_arch_config("facebook/hubert-large-ls960-ft",
                               kind="hubert").hidden_size == 1024

    cfg = Config().replace(data_root=str(tmp_path),
                           feature_extractor_type="wavlm")
    a = build_encoder(cfg, device="cpu", seed=5)
    b = build_encoder(cfg, device="cpu", seed=5)
    assert a.name == "wavlm" and not a.pretrained
    assert a.arch_cfg == twavlm.WavLMConfig() and a.feature_dim == 768
    torch.testing.assert_close(a.model.rel_attn_embed, b.model.rel_attn_embed)
    torch.testing.assert_close(a.model.layers[11]["gate"]["w"],
                               b.model.layers[11]["gate"]["w"])

    cfg = cfg.replace(wavlm_model_name="org/tiny-wavlm")
    ckdir = tmp_path / "weights" / "org--tiny-wavlm"
    ckdir.mkdir(parents=True)
    tcfg = twavlm.WavLMConfig(**TINY_LM)
    sd = _fake_wavlm_state_dict(rng, tcfg)
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               ckdir / "pytorch_model.bin")
    with open(ckdir / "config.json", "w") as f:
        json.dump({k: list(v) if isinstance(v, tuple) else v
                   for k, v in TINY_LM.items()}, f)
    enc = build_encoder(cfg, device="cpu")
    assert enc.pretrained and enc.arch_cfg == tcfg
    torch.testing.assert_close(
        enc.model.rel_attn_embed,
        torch.as_tensor(sd["encoder.layers.0.attention.rel_attn_embed."
                           "weight"]))
    feats = enc.segment_features(torch.as_tensor(_segments(rng, 2, 32000)))
    assert feats.shape == (2, 99, 64) and torch.isfinite(feats).all()
    # Whisper builds from the same config: seeded random whisper-tiny, its
    # architecture from the preset
    w = build_encoder(cfg.replace(feature_extractor_type="whisper",
                                  whisper_model_name="openai/whisper-tiny"),
                      device="cpu")
    assert w.name == "whisper" and not w.pretrained
    assert (w.arch_cfg.d_model, w.arch_cfg.num_hidden_layers,
            w.arch_cfg.num_attention_heads, w.feature_dim) == (384, 4, 6, 384)
