"""The layer-normed conv front end's bias add, LayerNorm over the channels
and tanh GELU: the one-pass kernel (``radad_tpu_torch/ops/
channel_ln_gelu.py``, ``csrc/channel_ln_gelu.cu``) against the op-by-op
chain, and the dispatch that picks between them.

The kernel sums its f32 statistics in another order than ``F.layer_norm``,
so its output is held to the chain by ``compare_with_chain``: every element
is the GELU of the chain's bf16 LayerNorm output y or of one of y's two
bf16 neighbours, or, where y is near 0 as the difference of two larger
terms, within the f32 reordering's band of the chain's f32 output. The
tests marked ``cuda`` run only on the card and skip
elsewhere; the others run on the CPU too. None imports JAX, so on a
machine with an NVIDIA GPU (where JAX need not be installed, hence no
conftest):

    python -m pytest --noconftest -p no:cacheprovider -q -s \\
        tests/test_torch_channel_ln_gelu.py
"""

import os

import pytest
import torch
import torch.nn.functional as F

from radad_tpu_torch.models import encoder_common as C
from radad_tpu_torch.models import wav2vec2 as W2
from radad_tpu_torch.models import wavlm as WL
from radad_tpu_torch.ops import _native
from radad_tpu_torch.ops import bias_gelu as BG
from radad_tpu_torch.ops import channel_ln_gelu as CLG

BF16 = torch.bfloat16
# the front end's conv outputs at 2 s windows (wavlm-large-bulk: 128
# windows), conv 0 .. 6
FRONTEND_T = (6399, 3199, 1599, 799, 399, 199, 99)
TINY = dict(hidden_size=32, num_attention_heads=4, num_hidden_layers=1,
            intermediate_size=64, conv_dim=(16, 16, 16, 16),
            conv_kernel=(10, 8, 4, 4), conv_stride=(5, 4, 4, 4),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == BF16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _old_feature_encoder(model, waveform):
    """The layer-normed conv stack before the kernel: the conv with its
    bias, LayerNorm through the transpose, the GELU on the normed
    ``[B, T, C]``, the transpose back."""
    cfg = model.cfg
    x = waveform[:, None, :]
    for i, layer in enumerate(model.conv_layers):
        x = C.conv1d(x, layer["kernel"], layer.get("bias"),
                     stride=cfg.conv_stride[i], padding=0)
        x = C.layer_norm(x.transpose(1, 2), layer["norm_scale"],
                         layer["norm_bias"])
        x = C.gelu_bias(x).transpose(1, 2)
    return x.transpose(1, 2)


def _model(kind, conv_bias, seed, device="cpu"):
    """A seeded layer-normed tiny wav2vec2 or WavLM, with random conv
    biases (when it has them) and norm affines."""
    mod, cfg_cls, cls = ((W2, W2.Wav2Vec2Config, W2.Wav2Vec2Model)
                         if kind == "wav2vec2"
                         else (WL, WL.WavLMConfig, WL.WavLMModel))
    cfg = cfg_cls(feat_extract_norm="layer", do_stable_layer_norm=True,
                  conv_bias=conv_bias, **TINY)
    g = torch.Generator().manual_seed(seed)
    model = mod.init_params(cls(cfg), g)
    with torch.no_grad():
        for layer in model.conv_layers:
            for name in ("bias", "norm_bias"):
                if name in layer:
                    layer[name].copy_(torch.randn(layer[name].shape,
                                                  generator=g) / 4)
            layer["norm_scale"].add_(torch.randn(
                layer["norm_scale"].shape, generator=g) / 4)
    return model.to(device)


def _params(c, seed, device="cpu", bias=True):
    g = torch.Generator().manual_seed(seed)
    b = (torch.randn(c, generator=g) / 2).to(BF16) if bias else None
    scale = 1 + torch.randn(c, generator=g) / 4
    shift = torch.randn(c, generator=g) / 4
    return [None if p is None else p.to(device) for p in (b, scale, shift)]


@pytest.fixture
def counts():
    """() -> (kernel launches, bf16 chains on the card op by op) since the
    test began."""
    CLG.reset_counts()
    BG.reset_counts()
    yield lambda: (CLG.channel_ln_gelu.launches,
                   CLG.channel_ln_gelu_plain.calls)
    CLG.reset_counts()
    BG.reset_counts()


# ------------------------------------------------------- on the CPU too
@pytest.mark.parametrize("conv_bias", [True, False])
@pytest.mark.parametrize("kind", ["wav2vec2", "wavlm"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_plain_chain_keeps_todays_bits(dtype, kind, conv_bias, counts):
    """A layer-normed tiny wav2vec2 and WavLM, with and without conv
    biases: the front end (``conv1d_ln_gelu``, the chain on the CPU) gives
    the bf16 bits of the order before the kernel; in f32 (the bias inside
    the product) it is within the CPU's erf rounding of them
    (``test_torch_bias_gelu``'s tolerance)."""
    model = _model(kind, conv_bias, 21)
    g = torch.Generator().manual_seed(22)
    wav = torch.randn((2, 4000), generator=g).to(dtype)
    new, old = W2.feature_encoder(model, wav), _old_feature_encoder(model,
                                                                    wav)
    if dtype == BF16:
        assert _same_bits(new, old)
    else:
        assert (new - old).abs().max() <= 1e-6 * old.abs().max()
    assert counts() == (0, 0)


@pytest.mark.parametrize("bias", [True, False])
def test_plain_chain_is_bias_add_layer_norm_gelu(bias):
    """``channel_ln_gelu_plain`` adds the bias in x's dtype along the
    channels, takes ``layer_norm`` in f32 through the transpose, rounds to
    x's dtype and runs the GELU, back in ``[B, C, T]``."""
    g = torch.Generator().manual_seed(23)
    x = (3 * torch.randn((2, 24, 37), generator=g)).to(BF16)
    b, scale, shift = _params(24, 24, bias=bias)
    shaped = x if b is None else x + b[:, None]
    want = C.gelu(C.layer_norm(shaped.transpose(1, 2), scale, shift))
    assert _same_bits(CLG.channel_ln_gelu_plain(x, b, scale, shift),
                      want.transpose(1, 2))


@pytest.mark.parametrize("case", ["bf16", "f32", "group", "non_contiguous",
                                  "requires_grad"])
def test_dispatch_keeps_the_kernel_off(case, counts, monkeypatch):
    """On the CPU, in f32, on a group-normed front end, on a non-contiguous
    input and on one that carries a gradient the kernel is not taken, the
    output is the chain's, and nothing is launched or counted."""
    g = torch.Generator().manual_seed(25)
    if case == "group":
        taken = []
        monkeypatch.setattr(C, "conv1d_ln_gelu",
                            lambda *a, **k: taken.append(a))
        cfg = W2.Wav2Vec2Config(feat_extract_norm="group", **TINY)
        model = W2.init_params(W2.Wav2Vec2Model(cfg), g)
        W2.feature_encoder(model, torch.randn((2, 4000), generator=g).to(
            BF16))
        assert taken == [] and counts() == (0, 0)
        return
    x = torch.randn((2, 16, 40), generator=g)
    x = x if case == "f32" else x.to(BF16)
    if case == "non_contiguous":
        x = x[:, :, ::2]
    if case == "requires_grad":
        x.requires_grad_(True)
    b, scale, shift = _params(16, 26)
    assert not CLG.use_channel_ln_gelu(x, b, scale, shift)
    got = CLG.channel_ln_gelu_plain(x, b, scale, shift)
    if case == "requires_grad":
        got.float().sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad.float()).all()
    assert counts() == (0, 0)


@pytest.mark.parametrize("case", ["x_f32", "bias_f32", "scale_bf16",
                                  "bias_length", "scale_length",
                                  "shift_length", "two_dims",
                                  "too_many_channels", "ragged_channels",
                                  "misaligned", "strided", "row_major",
                                  "cpu"])
def test_wrapper_refuses(case):
    """The kernel's wrapper raises on a dtype it does not take, on a
    parameter that does not fit the channels, on a tensor that is not a
    channels-last ``[B, C, T]`` of a multiple of 8 channels up to 512 at a
    16-byte aligned address (the kernel's 16-byte vectors), and off the
    card."""
    x = torch.zeros((2, 9, 16), dtype=BF16).transpose(1, 2)
    b, scale, shift = _params(16, 27)
    if case == "x_f32":
        x = x.float()
    elif case == "bias_f32":
        b = b.float()
    elif case == "scale_bf16":
        scale = scale.to(BF16)
    elif case == "bias_length":
        b = b[:15]
    elif case == "scale_length":
        scale = torch.ones(17)
    elif case == "shift_length":
        shift = shift[:8]
    elif case == "two_dims":
        x = x[0]
    elif case == "too_many_channels":
        x = torch.zeros((1, 9, 520), dtype=BF16).transpose(1, 2)
    elif case == "ragged_channels":
        x = torch.zeros((2, 9, 12), dtype=BF16).transpose(1, 2)
        b, scale, shift = _params(12, 27)
    elif case == "misaligned":  # one element past an aligned start
        x = torch.zeros(2 * 9 * 16 + 1, dtype=BF16)[1:].view(2, 9, 16)
        x = x.transpose(1, 2)
    elif case == "strided":
        x = x[:, :, ::2]
    elif case == "row_major":
        x = x.contiguous()
    err = TypeError if case in ("x_f32", "bias_f32", "scale_bf16") \
        else ValueError
    with pytest.raises(err):
        CLG.channel_ln_gelu(x, b, scale, shift)


@pytest.mark.parametrize("c_in,k,stride", [(16, 3, 2), (16, 2, 5),
                                            (1, 10, 5)])
def test_conv1d_channels_last_is_the_conv(c_in, k, stride):
    """``conv1d_channels_last`` (the card's bf16 front-end conv; with one
    input channel a product of the windows) is ``F.conv1d`` without bias,
    returned with the channels fastest."""
    g = torch.Generator().manual_seed(37)
    x = torch.randn((2, c_in, 101), generator=g)
    k = torch.randn((24, c_in, k), generator=g) / 7
    got = C.conv1d_channels_last(x, k, stride)
    want = F.conv1d(x, k, stride=stride)
    assert got.shape == want.shape and got.stride(1) == 1
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_kernel_is_a_built_library():
    """The kernel is one of ``_native``'s sources with its C entry, built
    without fast-math, and no kernel of it matches the attention roofline's
    ``mha_*kernel`` names."""
    assert "channel_ln_gelu" in _native.SOURCES
    assert "radad_channel_ln_gelu" in _native.ENTRIES["channel_ln_gelu"]
    path = os.path.join(_native.CSRC_DIR, "channel_ln_gelu.cu")
    with open(path) as f:
        src = f.read()
    assert 'extern "C" int radad_channel_ln_gelu(' in src
    assert "mha_" not in src
    assert "--use_fast_math" not in _native.NVCC_FLAGS


def _kernel_order(x, b, scale, shift, eps=1e-5, stats=torch.float32):
    """The kernel's arithmetic on the CPU: a plain sum of the values, then
    of the squared deviations (another order than F.layer_norm's), the
    statistics rounded to ``stats``."""
    v = (x if b is None else x + b[:, None]).float()
    mean = (v.sum(1, keepdim=True) / v.shape[1]).to(stats).float()
    var = ((v - mean) ** 2).sum(1, keepdim=True) / v.shape[1]
    rstd = torch.rsqrt(var + eps).to(stats).float()
    y = (scale[:, None] * (rstd * (v - mean)) + shift[:, None]).to(BF16)
    return BG.bias_gelu_plain(y)


@pytest.mark.parametrize("bias", [True, False])
def test_check_holds_another_order_and_refuses_a_lower_precision(bias):
    """``compare_with_chain`` holds the kernel's order of the f32 sums,
    emulated on the CPU, to the chain (with some elements' bits apart),
    and fails the same arithmetic with the statistics rounded to bf16: the
    check sees a change of precision."""
    g = torch.Generator().manual_seed(28)
    x = (4 * torch.randn((4, 512, 257), generator=g) + 1).to(BF16)
    b, scale, shift = _params(512, 29, bias=bias)
    held = CLG.compare_with_chain(_kernel_order(x, b, scale, shift), x, b,
                                  scale, shift)
    assert held["off"] == 0 and 0 < held["bits_apart"] < x.numel() // 100
    held = CLG.compare_with_chain(
        _kernel_order(x, b, scale, shift, stats=BF16), x, b, scale, shift)
    assert held["off"] > x.numel() // 100


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    from radad_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _held(cuda, shape, bias, seed):
    """The kernel on a seeded channels-last ``shape``: ``compare_with_chain``
    of its output."""
    bb, c, t = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (3 * torch.randn((bb, t, c), generator=g, device=cuda) + 0.5).to(
        BF16).transpose(1, 2)
    b, scale, shift = _params(c, seed, cuda, bias=bias)
    before = CLG.channel_ln_gelu.launches
    got = CLG.channel_ln_gelu(x, b, scale, shift)
    torch.cuda.synchronize()
    assert CLG.channel_ln_gelu.launches == before + 1
    assert got.stride() == x.stride()
    return CLG.compare_with_chain(got, x, b, scale, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("t", FRONTEND_T)
def test_front_end_shapes_on_card(cuda, t, bias):
    """The front end's seven conv outputs at 512 channels (4 windows), with
    and without the conv bias: every element held to the chain; the
    elements with bits apart and those more than one bf16 step of y apart
    (each within the band near 0) printed."""
    held = _held(cuda, (4, 512, t), bias, 30 + t)
    print(f"channel_ln_gelu [4, 512, {t}] bias={bias}: {held}")
    assert held["off"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 16, 37), (2, 16, 1), (1, 8, 33),
                                   (2, 8, 65)])
def test_ragged_shapes_on_card(cuda, shape):
    """Few channels (the tests' 16, and 8: one 16-byte vector a row, a
    lane's worth) and odd T, bias and none."""
    for bias in (True, False):
        assert _held(cuda, shape, bias, 31)["off"] == 0, (shape, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,stride", [(1, 5), (512, 2)])
def test_conv1d_channels_last_on_card(cuda, c_in, stride):
    """On the card in bf16, ``conv1d_channels_last`` writes the channels
    fastest and is the row-major conv but for its f32 summation order:
    within one bf16 step (2^-7 relative) of it, plus 2^-16 of the sum of
    the products' magnitudes where the sum cancels."""
    g = torch.Generator(device=cuda).manual_seed(38)
    x = torch.randn((4, c_in, 3201), generator=g, device=cuda).to(BF16)
    k = torch.randn((512, c_in, 3), generator=g, device=cuda) / 20
    got = C.conv1d_channels_last(x, k, stride)
    want = C.conv1d(x, k, None, stride, 0)
    assert got.shape == want.shape and got.transpose(1, 2).is_contiguous()
    err = (got.float() - want.float()).abs()
    mags = F.conv1d(x.float().abs(), k.to(BF16).float().abs(), stride=stride)
    assert (err <= 2.0 ** -7 * want.float().abs() + 2.0 ** -16 * mags).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "group", "requires_grad",
                                  "non_contiguous", "ragged_channels",
                                  "misaligned"])
def test_dispatch_on_card(cuda, case, counts):
    """On the card the kernel is not taken in f32 or on a group-normed
    front end (nothing counted), nor on an input that carries a gradient
    (the chain, counted, and the gradient flows); a non-contiguous input,
    one of 12 channels and one off a 16-byte boundary are refused by the
    predicate and the wrapper alike."""
    g = torch.Generator(device=cuda).manual_seed(32)
    if case in ("non_contiguous", "ragged_channels", "misaligned"):
        c = 12 if case == "ragged_channels" else 16
        x = torch.randn((2, 40, c), generator=g, device=cuda).to(BF16)
        if case == "misaligned":
            x = x.flatten()[1:1 + 2 * 39 * c].view(2, 39, c)
        x = x.transpose(1, 2)
        if case == "non_contiguous":
            x = x.contiguous()[:, :, ::2]
        b, scale, shift = _params(c, 33, cuda)
        assert not CLG.use_channel_ln_gelu(x, b, scale, shift)
        with pytest.raises(ValueError):
            CLG.channel_ln_gelu(x, b, scale, shift)
        assert counts() == (0, 0)
        return
    if case == "group":
        cfg = W2.Wav2Vec2Config(feat_extract_norm="group", conv_bias=True,
                                **TINY)
        model = W2.init_params(W2.Wav2Vec2Model(cfg),
                               torch.Generator().manual_seed(34)).to(cuda)
    else:
        model = _model("wavlm", True, 34, cuda)
    wav = torch.randn((2, 4000), generator=g, device=cuda) / 10
    if case != "f32":
        wav = wav.to(BF16)
    if case == "requires_grad":
        wav.requires_grad_(True)
        W2.feature_encoder(model, wav).float().sum().backward()
        assert wav.grad is not None
        assert counts() == (0, len(model.conv_layers))
        return
    with torch.no_grad():
        W2.feature_encoder(model, wav)
    assert counts() == (0, 0)


def _wavlm_large(cuda):
    """WavLM-Large at its published widths (the port's preset), seeded."""
    from radad_tpu_torch.models.encoder import resolve_arch_config

    cfg = resolve_arch_config("microsoft/wavlm-large", kind="wavlm")
    return WL.init_params(WL.WavLMModel(cfg),
                          torch.Generator().manual_seed(35)).to(cuda)


@pytest.mark.cuda
def test_wavlm_large_forward_on_card(cuda, counts):
    """A bf16 WavLM-Large forward of 2 windows of 2 s: 7 kernel launches
    (one a conv layer), no chain op by op, and ``bias_gelu`` only for the positional conv and the 24 FFNs
    (25, 7 fewer than before); each conv layer's output is held to the
    chain on its own input."""
    model = _wavlm_large(cuda)
    g = torch.Generator(device=cuda).manual_seed(36)
    wav = torch.randn((2, 32000), generator=g, device=cuda) / 10
    with torch.no_grad():
        WL.extract_features(model, wav, dtype=BF16)
        torch.cuda.synchronize()
        assert counts() == (7, 0)
        assert (BG.bias_gelu.launches, BG.bias_gelu_plain.calls) == (25, 0)
        x = wav.to(BF16)[:, None, :]
        cfg = model.cfg
        for i, layer in enumerate(model.conv_layers):
            out = C.conv1d_channels_last(x, layer["kernel"],
                                         cfg.conv_stride[i])
            b = layer["bias"].to(BF16)
            scale, shift = layer["norm_scale"], layer["norm_bias"]
            x = CLG.channel_ln_gelu(out, b, scale, shift)
            held = CLG.compare_with_chain(x, out, b, scale, shift)
            print(f"wavlm-large conv {i} {list(out.shape)}: {held}")
            assert held["off"] == 0, i
