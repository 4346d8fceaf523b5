"""Port wav2vec2 encoder against the JAX encoder on the CPU (f32): the
weights bridge (models/convert.py) and the HF state-dict converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.models import hf_convert as jhf
from radad_tpu.models.encoder import FrozenEncoder as JEnc
from radad_tpu.models.wav2vec2 import Wav2Vec2Config as JW, init_params
from radad_tpu_torch.models import hf_convert as thf
from radad_tpu_torch.models.convert import encoder_from_jax
from radad_tpu_torch.models.encoder import FrozenEncoder as TEnc
from radad_tpu_torch.models.encoder import build_encoder, resolve_arch_config
from radad_tpu_torch.models.wav2vec2 import Wav2Vec2Config as TW
from radad_tpu_torch.models.whisper import WhisperConfig

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, conv_dim=(16, 16, 16, 16),
            conv_kernel=(10, 8, 4, 4), conv_stride=(5, 4, 4, 4),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def _pair(params, layers=(-2, -1), normalize=False, model=None):
    jenc = JEnc(name="wav2vec2", model_name="tiny", arch_cfg=JW(**TINY),
                params=params, pretrained=False, layers_to_use=layers,
                input_normalize=normalize)
    if model is None:
        model = encoder_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 TW(**TINY))
    tenc = TEnc(name="wav2vec2", model_name="tiny", arch_cfg=TW(**TINY),
                model=model, pretrained=False, layers_to_use=layers,
                input_normalize=normalize)
    return jenc, tenc


@pytest.mark.parametrize("layers,normalize", [((-2, -1), False),
                                              ((-4, -3, -2, -1), True)])
def test_segment_features_match_jax(layers, normalize, rng):
    params = init_params(jax.random.PRNGKey(3), JW(**TINY))
    jenc, tenc = _pair(params, layers, normalize)
    segs = (0.3 * rng.standard_normal((2, 2, 32000))).astype(np.float32)
    want = np.asarray(jenc.segment_features(params, jnp.asarray(segs)))
    got = tenc.segment_features(torch.as_tensor(segs)).numpy()
    assert got.shape == want.shape == (2, 2, 99, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _fake_hf_state_dict(rng, cfg):
    """Random HF Wav2Vec2Model-style state dict (torch layouts, weight-
    normed positional conv)."""
    def r(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    sd = {}
    cin = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = r(c, cin, k)
        cin = c
    sd["feature_extractor.conv_layers.0.layer_norm.weight"] = 1 + r(cin)
    sd["feature_extractor.conv_layers.0.layer_norm.bias"] = r(cin)
    d, f = cfg.hidden_size, cfg.intermediate_size
    sd["feature_projection.layer_norm.weight"] = 1 + r(cin)
    sd["feature_projection.layer_norm.bias"] = r(cin)
    sd["feature_projection.projection.weight"] = r(d, cin)
    sd["feature_projection.projection.bias"] = r(d)
    g = cfg.num_conv_pos_embedding_groups
    pre = "encoder.pos_conv_embed.conv"
    sd[f"{pre}.weight_g"] = 1 + r(1, 1, cfg.num_conv_pos_embeddings)
    sd[f"{pre}.weight_v"] = r(d, d // g, cfg.num_conv_pos_embeddings)
    sd[f"{pre}.bias"] = r(d)
    sd["encoder.layer_norm.weight"] = 1 + r(d)
    sd["encoder.layer_norm.bias"] = r(d)
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layers.{i}"
        for hf in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.attention.{hf}.weight"] = r(d, d)
            sd[f"{p}.attention.{hf}.bias"] = r(d)
        for hf in ("layer_norm", "final_layer_norm"):
            sd[f"{p}.{hf}.weight"] = 1 + r(d)
            sd[f"{p}.{hf}.bias"] = r(d)
        sd[f"{p}.feed_forward.intermediate_dense.weight"] = r(f, d)
        sd[f"{p}.feed_forward.intermediate_dense.bias"] = r(f)
        sd[f"{p}.feed_forward.output_dense.weight"] = r(d, f)
        sd[f"{p}.feed_forward.output_dense.bias"] = r(d)
    return sd


def test_hf_convert_matches_jax(rng, tmp_path):
    """One HF state dict through both converters gives the same features;
    the port also loads it from a local checkpoint file."""
    sd = _fake_hf_state_dict(rng, TW(**TINY))
    params = jhf.convert_wav2vec2(sd, JW(**TINY))
    model = thf.convert_wav2vec2(
        {k: torch.as_tensor(v) for k, v in sd.items()}, TW(**TINY))
    jenc, tenc = _pair(params, model=model)
    segs = (0.3 * rng.standard_normal((3, 16000))).astype(np.float32)
    want = np.asarray(jenc.segment_features(params, jnp.asarray(segs)))
    got = tenc.segment_features(torch.as_tensor(segs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    path = tmp_path / "pytorch_model.bin"
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    loaded = thf.load_state_dict(str(path))
    assert set(loaded) == set(sd)


def test_build_encoder_random_and_local(tmp_path, rng):
    """No checkpoint → seeded random init at the configured width (same
    seed, same weights); a local checkpoint + config.json is loaded."""
    import json

    from radad_tpu_torch.config import Config

    cfg = Config().replace(data_root=str(tmp_path),
                           wav2vec2_model_name="org/tiny-w2v")
    assert resolve_arch_config("facebook/wav2vec2-base-960h") == TW()
    ckdir = tmp_path / "weights" / "org--tiny-w2v"
    ckdir.mkdir(parents=True)
    sd = _fake_hf_state_dict(rng, TW(**TINY))
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               ckdir / "pytorch_model.bin")
    with open(ckdir / "config.json", "w") as f:
        json.dump({k: list(v) if isinstance(v, tuple) else v
                   for k, v in TINY.items()}, f)
    enc = build_encoder(cfg, device="cpu")
    assert enc.pretrained and enc.arch_cfg == TW(**TINY)
    torch.testing.assert_close(
        enc.model.layers[1]["ffn"]["w2"],
        torch.as_tensor(sd["encoder.layers.1.feed_forward.output_dense."
                           "weight"]))

    (ckdir / "pytorch_model.bin").unlink()
    a = build_encoder(cfg, device="cpu", seed=5)
    b = build_encoder(cfg, device="cpu", seed=5)
    assert not a.pretrained
    assert a.arch_cfg == TW()  # unknown name → base width
    torch.testing.assert_close(a.model.pos_conv["kernel"],
                               b.model.pos_conv["kernel"])
    # Whisper builds from the same config: seeded random whisper-base
    w = build_encoder(cfg.replace(feature_extractor_type="whisper"),
                      device="cpu")
    assert w.name == "whisper" and not w.pretrained
    assert w.arch_cfg == WhisperConfig() and w.feature_dim == 512
