"""WavLM-Large's stable-LN path (a layer-norm conv front end with conv
biases, pre-LN layers, the encoder LN last, the gated relative position
bias) against the benchmark's plain reference
(``h100_bench/encoders/wavlm.py``) at its CPU cut (``TINY``), and that
reference against ``transformers.WavLMModel``. Imports no JAX, so it also
runs on the card without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_wavlm_large.py
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

# the benchmark's modules, as h100_bench/run.py puts them on the path
BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "h100_bench")
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from harness import common  # noqa: E402
from harness import weights as W  # noqa: E402
from radad_tpu_torch.models import encoder_common, hf_convert  # noqa: E402
from radad_tpu_torch.models import wavlm as twavlm  # noqa: E402
from radad_tpu_torch.models.encoder import FrozenEncoder  # noqa: E402
from radad_tpu_torch.ops.attention import fused_mha  # noqa: E402

CONFIG = "wavlm-large-itw-bf16"
SEED = 2**31 + 7
F32_TOL = 1e-5  # |port - ref| <= F32_TOL (1 + |ref|): f32 summation order
# bf16 against the float32 reference, the worst frame's relative error: the
# port reads 0.037 at this cut, the float8 control 0.32
BF16_BAND = 0.1
# the reference against transformers.WavLMModel: HF projects q, k, v in one
# in-projection and sums through multi_head_attention_forward, another f32
# order (it reads 2e-6 to 5e-6 here; the bias controls read 0.097 and more)
HF_TOL = 3e-5


def _config(full: bool = False) -> dict:
    cfg = copy.deepcopy(common.load_config(CONFIG))
    if not full:
        for part, cut in common.encoder(cfg).TINY.items():
            cfg[part].update(cut)
    return cfg


def _arch(cfg):
    return twavlm.WavLMConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in cfg["architecture"].items()})


def _weights(cfg, device="cpu"):
    return W.make(common.encoder(cfg).weights(cfg["architecture"]), SEED,
                  device)


def _port(cfg, p, dtype=torch.float32, device="cpu"):
    with torch.device(device):
        model = twavlm.WavLMModel(_arch(cfg))
    model.load_state_dict(p, strict=True)
    return FrozenEncoder(
        name="wavlm", model_name=cfg["model_name"], arch_cfg=_arch(cfg),
        model=model.eval(), pretrained=False,
        input_normalize=cfg["pipeline"]["input_normalize"],
        compute_dtype=dtype)


def _segments(n, samples=32000, seed=0, device="cpu"):
    x = np.random.default_rng(seed).standard_normal((n, samples))
    return torch.as_tensor(0.1 * x, dtype=torch.float32, device=device)


def _reference(cfg, p, seg, kinds=None):
    with torch.no_grad():
        return common.encoder(cfg).features(p, cfg["architecture"],
                                            cfg["pipeline"], seg, kinds or {})


def _elementwise(got, ref):
    return float(((got - ref).abs() / (1 + ref.abs())).max())


def _frame_rel(got, ref):
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


@pytest.mark.parametrize("samples,normalize", [(32000, True), (16000, True),
                                               (32000, False)])
def test_port_matches_the_plain_reference_in_f32(samples, normalize):
    cfg = _config()
    cfg["pipeline"]["input_normalize"] = normalize
    p = _weights(cfg)
    seg = _segments(3, samples)
    got = _port(cfg, p).segment_features(seg)
    ref = _reference(cfg, p, seg)
    assert got.shape == ref.shape == (3, 99 if samples == 32000 else 49, 32)
    assert _elementwise(got, ref) <= F32_TOL


def test_port_bf16_within_the_band_the_float8_control_fails():
    cfg = _config()
    p = _weights(cfg)
    seg = _segments(4)
    ref = _reference(cfg, p, seg)
    port = _frame_rel(_port(cfg, p, torch.bfloat16).segment_features(seg),
                      ref)
    control = _frame_rel(_reference(cfg, p, seg, {"encoder": "fp8"}), ref)
    assert port <= BF16_BAND < control, (port, control)
    assert control >= 3 * port


def _hf_model(cfg, seed):
    """``transformers.WavLMModel`` at the configuration's architecture, each
    parameter drawn from ``seed``: norms near 1, gate constants around 1,
    ``rel_attn_embed`` at unit variance, the rest +-1/sqrt(fan_in)."""
    transformers = pytest.importorskip("transformers")
    a = cfg["architecture"]
    hf_cfg = transformers.WavLMConfig(
        hidden_size=a["hidden_size"],
        num_hidden_layers=a["num_hidden_layers"],
        num_attention_heads=a["num_attention_heads"],
        intermediate_size=a["intermediate_size"], conv_dim=a["conv_dim"],
        conv_kernel=a["conv_kernel"], conv_stride=a["conv_stride"],
        conv_bias=a["conv_bias"], feat_extract_norm=a["feat_extract_norm"],
        num_conv_pos_embeddings=a["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=a["num_conv_pos_embedding_groups"],
        layer_norm_eps=a["layer_norm_eps"], num_buckets=a["num_buckets"],
        max_bucket_distance=a["max_bucket_distance"],
        do_stable_layer_norm=a["do_stable_layer_norm"])
    model = transformers.WavLMModel(hf_cfg).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.named_parameters():
            u = torch.rand(t.shape, generator=g) * 2 - 1
            if "rel_attn_embed" in name:
                t.copy_(u * 3 ** 0.5)
            elif "gru_rel_pos_const" in name or "original0" in name \
                    or (t.dim() == 1 and "norm" in name and "weight" in name):
                t.copy_(1 + 0.5 * u)
            elif t.dim() == 1:
                t.copy_(0.1 * u)
            else:
                t.copy_(u / (t[0].numel() ** 0.5))
    return model


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_transformers_wavlm(seed):
    cfg = _config()
    cfg["pipeline"]["input_normalize"] = False  # HF's processor's work
    hf = _hf_model(cfg, seed)
    p = dict(hf_convert.convert_wavlm(hf.state_dict(), _arch(cfg))
             .state_dict())
    seg = _segments(2, seed=seed)
    with torch.no_grad():
        want = hf(seg).last_hidden_state
    assert _elementwise(_reference(cfg, p, seg), want) <= HF_TOL


def _no_bias(enc, monkeypatch):
    return {"rel_bias": "off"}


def _gate_one(enc, monkeypatch):
    def ones(x, p, pre, heads, kind):
        b, t, _ = x.shape
        return torch.ones(b, heads, t)
    monkeypatch.setattr(enc, "gate", ones)
    return {}


def _bucket_sign(enc, monkeypatch):
    buckets = enc.buckets
    monkeypatch.setattr(enc, "buckets", lambda *a: buckets(*a).T)
    return {}


@pytest.mark.parametrize("control", [_no_bias, _gate_one, _bucket_sign])
def test_controls_of_the_bias_fail_the_f32_tolerance(control, monkeypatch):
    cfg = _config()
    p = _weights(cfg)
    seg = _segments(3)
    got = _port(cfg, p).segment_features(seg)
    kinds = control(common.encoder(cfg), monkeypatch)
    assert _elementwise(got, _reference(cfg, p, seg, kinds)) > 100 * F32_TOL


@pytest.mark.parametrize("t", [1, 2, 99, 800, 1500])
def test_position_bias_keeps_the_numpy_buckets_on_the_device(t):
    cfg = _config()
    model = _port(cfg, _weights(cfg)).model
    want = twavlm.relative_position_buckets(t, 320, 800)
    pos = twavlm.position_bias(model, t)
    (key, buckets), = model.buckets.items()
    assert key == (t, model.rel_attn_embed.device)
    assert np.array_equal(buckets.numpy(), want)
    table = model.rel_attn_embed.detach()
    assert torch.equal(pos, table[torch.as_tensor(want)].permute(2, 0, 1))
    # a later forward builds nothing: the same matrix, no host copy
    assert torch.equal(twavlm.position_bias(model, t), pos)
    assert model.buckets[key] is buckets


def test_spans_name_the_front_end_the_bias_and_each_gate():
    from torch.profiler import ProfilerActivity, profile

    cfg = _config()
    enc = _port(cfg, _weights(cfg))
    seg = _segments(2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enc.segment_features(seg)
    names = [e.name for e in prof.events()]
    layers = cfg["architecture"]["num_hidden_layers"]
    assert names.count("radad.encoder.frontend") == 1
    assert names.count("radad.wavlm.pos_bias") == 1
    assert names.count("radad.wavlm.gate") == layers


@pytest.mark.cuda
def test_published_widths_take_the_bias_body_on_the_card(monkeypatch):
    """wavlm-large at its published widths in bf16 with fused attention:
    24 bias-body launches a forward, none through ``mha_reference``, within
    the CPU cut's band of the float32 reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: fused_mha runs only on the card")
    from radad_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    monkeypatch.setenv("RADAD_FUSED_ATTENTION", "1")

    def refused(*a, **kw):
        raise AssertionError("a WavLM attention took mha_reference")
    monkeypatch.setattr(encoder_common, "mha_reference", refused)
    cfg = _config(full=True)
    p = _weights(cfg, dev)
    seg = _segments(4, device=dev)
    enc = _port(cfg, p, torch.bfloat16, dev)
    before = fused_mha.body_launches["bias_bf16"]
    got = enc.segment_features(seg)
    torch.cuda.synchronize()
    assert fused_mha.body_launches["bias_bf16"] - before == 24
    ref = _reference(cfg, p, seg)
    err = _frame_rel(got, ref)
    print(f"wavlm-large bf16 on the card: worst frame {err:.4g} of the "
          f"float32 reference")
    assert err <= BF16_BAND
