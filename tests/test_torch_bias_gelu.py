"""The bias add and tanh GELU of the bf16 encoders: the one-pass kernel
(``radad_tpu_torch/ops/bias_gelu.py``, ``csrc/bias_gelu.cu``) against the
op-by-op chain, bit for bit, and the dispatch that picks between them.

The tests marked ``cuda`` run only on the card and skip elsewhere; the
others run on the CPU too. None imports JAX, so on a machine with an
NVIDIA GPU (where JAX need not be installed, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_bias_gelu.py
"""

import math
import os

import pytest
import torch
import torch.nn.functional as F

from radad_tpu_torch.models import encoder_common as C
from radad_tpu_torch.models import wav2vec2 as W2
from radad_tpu_torch.ops import _native
from radad_tpu_torch.ops import bias_gelu as BG
from radad_tpu_torch.ops import channel_ln_gelu as CLG

BF16 = torch.bfloat16


def _old_gelu(x):
    """The encoders' GELU before the kernel: exact in f32, the tanh form op
    by op in bf16."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    c = C.rounded(math.sqrt(2 / math.pi), x.dtype)
    inner = x + C.rounded(0.044715, x.dtype) * (x * (x * x))
    return x * (0.5 * (1.0 + torch.tanh(c * inner)))


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == BF16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _old_feature_encoder(model, waveform):
    """wav2vec2's conv stack before the kernel: each GELU after the norm's
    transpose back."""
    cfg = model.cfg
    x = waveform[:, None, :]
    for i, layer in enumerate(model.conv_layers):
        x = C.conv1d(x, layer["kernel"], layer.get("bias"),
                     stride=cfg.conv_stride[i], padding=0)
        if "norm_scale" in layer:
            if cfg.feat_extract_norm == "group":
                x = C.instance_norm_channels(x, layer["norm_scale"],
                                             layer["norm_bias"])
            else:
                x = C.layer_norm(x.transpose(1, 2), layer["norm_scale"],
                                 layer["norm_bias"]).transpose(1, 2)
        x = _old_gelu(x)
    return x.transpose(1, 2)


def _old_positional_conv(model, x):
    """wav2vec2's positional conv before the kernel: GELU after the trim
    and the transpose."""
    k = model.cfg.num_conv_pos_embeddings
    out = C.conv1d(x.transpose(1, 2), model.pos_conv["kernel"],
                   model.pos_conv["bias"], stride=1, padding=k // 2,
                   groups=model.cfg.num_conv_pos_embedding_groups)
    if k % 2 == 0:
        out = out[:, :, :-1]
    return _old_gelu(out.transpose(1, 2))


def _wav2vec2(norm, seed, device="cpu", **sizes):
    """A seeded wav2vec2 with ``norm`` feature norms, conv biases and
    random biases and norm affines (zeros and ones would hide a
    misplaced add)."""
    cfg = W2.Wav2Vec2Config(feat_extract_norm=norm, conv_bias=True,
                            do_stable_layer_norm=norm == "layer", **sizes)
    g = torch.Generator().manual_seed(seed)
    model = W2.init_params(W2.Wav2Vec2Model(cfg), g)
    with torch.no_grad():
        for layer in model.conv_layers:
            for name in ("bias", "norm_bias"):
                if name in layer:
                    layer[name].copy_(torch.randn(layer[name].shape,
                                                  generator=g) / 4)
            if "norm_scale" in layer:
                layer["norm_scale"].add_(torch.randn(
                    layer["norm_scale"].shape, generator=g) / 4)
        model.pos_conv["bias"].copy_(torch.randn(cfg.hidden_size,
                                                 generator=g) / 4)
    return model.to(device)


@pytest.fixture
def counts():
    """() -> (kernel launches, bf16 GELUs on the card op by op) since the
    test began."""
    BG.reset_counts()
    yield lambda: (BG.bias_gelu.launches, BG.bias_gelu_plain.calls)
    BG.reset_counts()


# ------------------------------------------------------- on the CPU too
@pytest.mark.parametrize("case", ["f32", "bf16", "non_contiguous",
                                  "requires_grad"])
def test_gelu_dispatch_keeps_todays_code_off_the_card(case, counts):
    """On the CPU, in f32, on a non-contiguous input and on one that
    carries a gradient, ``gelu_bias`` and ``gelu`` give the bits of the
    code before the kernel, and nothing is launched or counted."""
    g = torch.Generator().manual_seed(0)
    x = 3 * torch.randn((4, 6, 40), generator=g)
    if case != "f32":
        x = x.to(BF16)
    if case == "non_contiguous":
        x = x[:, :, ::2]
    if case == "requires_grad":
        x.requires_grad_(True)
    assert not BG.use_bias_gelu(x)
    got = C.gelu_bias(x)
    assert _same_bits(got, _old_gelu(x)) and _same_bits(C.gelu(x), got)
    if case == "requires_grad":
        got.float().sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad.float()).all()
    assert counts() == (0, 0)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_linear_and_conv_gelu_keep_their_bits(dtype, counts):
    """``linear_gelu`` and ``conv1d_gelu`` (the FFN's first layer,
    Whisper's convs) give what ``gelu(linear(x, w, b))`` and
    ``gelu(conv1d(x, k, b))`` gave, bit for bit, in f32 (the bias inside
    the product) and in bf16 (the product rounded, then the bias)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 9, 32), generator=g).to(dtype)
    w, b = torch.randn((48, 32), generator=g) / 6, torch.randn(48, generator=g)
    assert _same_bits(C.linear_gelu(x, w, b), _old_gelu(C.linear(x, w, b)))
    xc = torch.randn((2, 8, 37), generator=g).to(dtype)
    k, kb = torch.randn((16, 8, 3), generator=g) / 5, torch.randn(
        16, generator=g)
    for stride in (1, 2):
        assert _same_bits(C.conv1d_gelu(xc, k, kb, stride, 1),
                          _old_gelu(C.conv1d(xc, k, kb, stride, 1)))
    assert counts() == (0, 0)


def _wav2vec2_convs(model, dtype, device="cpu"):
    """wav2vec2's conv stack and positional conv on seeded inputs, in the
    order before the kernel and in today's: [(old, new)]."""
    g = torch.Generator(device=device).manual_seed(12)
    wav = torch.randn((2, 4000), generator=g, device=device).to(dtype)
    feats = W2.feature_encoder(model, wav)
    x = torch.randn((2, feats.shape[1], model.cfg.hidden_size), generator=g,
                    device=device).to(dtype)
    return [(_old_feature_encoder(model, wav), feats),
            (_old_positional_conv(model, x), W2.positional_conv(model, x))]


TINY_W2V2 = dict(hidden_size=32, num_attention_heads=4, num_hidden_layers=1,
                 intermediate_size=64, conv_dim=(16, 16, 16, 16),
                 conv_kernel=(10, 8, 4, 4), conv_stride=(5, 4, 4, 4),
                 num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.mark.parametrize("norm", ["group", "layer"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wav2vec2_convs_keep_their_bits(dtype, norm, counts):
    """wav2vec2's conv stack (group-normed first conv, or every conv
    layer-normed) and its positional conv, with the GELU taken before the
    transpose back and before the trim, give the bf16 bits of the order
    before the kernel (GELU last). In f32 on the CPU the GELU of a
    contiguous tensor takes the vectorized erf, that of a strided one the
    scalar erf, a few f32 roundings apart (on the card one function does
    both: ``test_wav2vec2_convs_on_card`` holds f32 to its bits)."""
    model = _wav2vec2(norm, 11, **TINY_W2V2)
    for old, new in _wav2vec2_convs(model, dtype):
        if dtype == BF16:
            assert _same_bits(new, old)
        else:
            assert (new - old).abs().max() <= 1e-6 * old.abs().max()
    assert counts() == (0, 0)


@pytest.mark.parametrize("channel_axis", [False, True])
def test_plain_chain_is_the_bias_add_then_gelu(channel_axis):
    """``bias_gelu_plain`` adds the bias in x's dtype along the named axis,
    then runs the op-by-op GELU."""
    g = torch.Generator().manual_seed(2)
    x = (4 * torch.randn((3, 5, 7), generator=g)).to(BF16)
    b = torch.randn(5 if channel_axis else 7, generator=g)
    shaped = b.to(BF16)[:, None] if channel_axis else b.to(BF16)
    assert _same_bits(BG.bias_gelu_plain(x, b, channel_axis),
                      _old_gelu(x + shaped))
    assert _same_bits(BG.bias_gelu_plain(x), _old_gelu(x))


@pytest.mark.parametrize("case", ["x_f32", "bias_f32", "cpu",
                                  "bias_length", "channel_length",
                                  "channel_1d"])
def test_bias_gelu_wrapper_refuses(case):
    """The kernel's wrapper raises on a dtype other than bf16, on a tensor
    off the card and on a bias that does not fit the named axis."""
    x = torch.zeros((2, 4, 16), dtype=BF16)
    b = torch.zeros(16, dtype=BF16)
    kw = {}
    if case == "x_f32":
        x = x.float()
    elif case == "bias_f32":
        b = b.float()
    elif case == "bias_length":
        b = torch.zeros(15, dtype=BF16)
    elif case == "channel_length":
        kw["channel_axis"] = True  # axis 1 holds 4, the bias 16
    elif case == "channel_1d":
        x, b = torch.zeros(16, dtype=BF16), torch.zeros(16, dtype=BF16)
        kw["channel_axis"] = True
    err = {"x_f32": TypeError, "bias_f32": TypeError}.get(case, ValueError)
    with pytest.raises(err):
        BG.bias_gelu(x, b, **kw)


def test_bias_gelu_is_a_built_kernel():
    """The kernel is one of ``_native``'s sources, built with the others."""
    assert "bias_gelu" in _native.SOURCES
    assert os.path.exists(os.path.join(_native.CSRC_DIR, "bias_gelu.cu"))
    assert "--use_fast_math" not in _native.NVCC_FLAGS


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    from radad_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _fused_equals_chain(x, bias=None, channel_axis=False):
    got = BG.bias_gelu(x, bias, channel_axis)
    want = BG.bias_gelu_plain(x, bias, channel_axis)
    torch.cuda.synchronize()
    assert got.stride() == want.stride()
    return _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,t,d,f", [(128, 1500, 512, 2048),
                                        (4, 99, 512, 2048),
                                        (128, 149, 768, 3072)])
def test_ffn_hidden_state_on_card(cuda, rows, t, d, f, counts):
    """The FFN's first product (whisper-base: 512 -> 2,048, at 128 padded
    windows and at a small batch; wav2vec2-base: 768 -> 3,072 at 128
    windows of 3 s), bias along the last axis: the kernel's bits are the
    chain's; one launch."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((rows, t, d), generator=g, device=cuda).to(BF16)
    w = (torch.randn((f, d), generator=g, device=cuda) / d ** 0.5).to(BF16)
    b = torch.randn(f, generator=g, device=cuda).to(BF16)
    h = F.linear(x, w)
    assert _fused_equals_chain(h, b)
    assert counts() == (1, 1)
    assert _same_bits(C.linear_gelu(x, w, b), _old_gelu(C.linear(x, w, b)))


@pytest.mark.cuda
@pytest.mark.parametrize("stride,t_in", [(1, 3000), (2, 3000), (1, 2999)])
def test_whisper_conv_outputs_on_card(cuda, stride, t_in):
    """conv1 ([B, 512, 3,000]) and conv2 ([B, 512, 1,500], T not a multiple
    of 8; and an odd T) with the bias along the channels, the conv's input
    transposed as Whisper's mel is: the kernel's bits are the chain's."""
    g = torch.Generator(device=cuda).manual_seed(4)
    c_in = 80 if stride == 1 else 512
    x = torch.randn((8, t_in, c_in), generator=g,
                    device=cuda).to(BF16).transpose(1, 2)
    k = (torch.randn((512, c_in, 3), generator=g, device=cuda) / 30)
    b = torch.randn(512, generator=g, device=cuda).to(BF16)
    out = C.conv1d(x, k, None, stride, 1)
    assert BG.use_bias_gelu(out, b)
    assert _fused_equals_chain(out, b, channel_axis=True)
    assert _same_bits(C.conv1d_gelu(x, k, b, stride, 1),
                      _old_gelu(C.conv1d(x, k, b, stride, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["group", "layer"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wav2vec2_convs_on_card(cuda, dtype, norm, counts, monkeypatch):
    """On the card, wav2vec2's conv stack and positional conv give the bits
    of the order before the kernel in f32 and in bf16; in bf16 every GELU
    of the new order is the kernel (5 of them), none op by op. The
    layer-normed stack in bf16 takes ``channel_ln_gelu`` at each of its 4
    conv layers instead (``bias_gelu`` then runs once, for the positional
    conv, which keeps its bits): a reduction across the channels cannot
    keep ``F.layer_norm``'s summation order, so each layer's output is held
    to the chain on that layer's own input (``compare_with_chain``)."""
    model = _wav2vec2(norm, 11, cuda, **TINY_W2V2)
    fused_ln = dtype == BF16 and norm == "layer"
    held, kernel = [], CLG.channel_ln_gelu
    CLG.reset_counts()

    def checked(x, b, scale, shift, eps=1e-5):
        out = kernel(x, b, scale, shift, eps)
        held.append(CLG.compare_with_chain(out, x, b, scale, shift,
                                           eps)["off"])
        return out
    monkeypatch.setattr(C, "channel_ln_gelu", checked)
    with torch.no_grad():
        pairs = _wav2vec2_convs(model, dtype, cuda)
    for i, (old, new) in enumerate(pairs):
        if fused_ln and i == 0:  # the conv stack
            assert held == [0] * 4 and (CLG.channel_ln_gelu.launches,
                                        CLG.channel_ln_gelu_plain.calls) \
                == (4, 0)
        else:
            assert _same_bits(new, old)
    assert held == ([0] * 4 if fused_ln else [])
    assert counts() == ((1 if fused_ln else 5, 0) if dtype == BF16
                        else (0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 512, 3199), (128, 512, 9599)])
def test_no_bias_on_card(cuda, shape, counts):
    """GELU alone (wav2vec2's normed conv layers; its group-normed first
    conv at 128 windows of 3 s): the chain's bits."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = (3 * torch.randn(shape, generator=g, device=cuda)).to(BF16)
    assert _fused_equals_chain(x)
    assert _same_bits(C.gelu_bias(x), _old_gelu(x))
    assert counts() == (2, 1)


def _every_bf16(cuda, shape):
    """All 65,536 bf16 bit patterns (then zeros) laid out as ``shape``."""
    n = math.prod(shape)
    bits = torch.arange(-2**15, 2**15, device=cuda, dtype=torch.int32)
    flat = torch.zeros(n, device=cuda, dtype=torch.int16)
    flat[:2**16] = bits.to(torch.int16)
    return flat.view(BF16).view(shape)


SPECIAL_BIASES = (0.0, 1.0, -0.5, 3.0, 1e-40, -1e-39, float("inf"),
                  float("-inf"), float("nan"), 3e38)


@pytest.mark.cuda
def test_every_bf16_value_on_card(cuda):
    """Each of the 65,536 bf16 patterns as x (denormals, +-inf, NaNs of
    either sign and payload), under bias 0, under each of a few non-zero
    biases (denormal, +-inf, NaN, near the largest bf16) and under a
    random bias: along a last axis of 256, along one of 257 (not a
    multiple of 8), along the channels of [2, 64, 513], through a
    misaligned start (every element one at a time), and without a bias."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = _every_bf16(cuda, (256, 256))
    for value in SPECIAL_BIASES:
        b = torch.full((256,), value, device=cuda).to(BF16)
        assert _fused_equals_chain(x, b), value
    assert _fused_equals_chain(x)
    rand = (torch.randn(257, generator=g, device=cuda) * 4).to(BF16)
    rand[:len(SPECIAL_BIASES)] = torch.tensor(SPECIAL_BIASES).to(BF16)
    x257 = _every_bf16(cuda, (256, 257))
    assert _fused_equals_chain(x257, rand)
    x513 = _every_bf16(cuda, (2, 64, 513))
    assert _fused_equals_chain(x513, rand[:64], channel_axis=True)
    storage = torch.cat([torch.zeros(1, device=cuda, dtype=BF16),
                         x.flatten()])
    odd = storage[1:].view(256, 256)  # 2 bytes past a 16-byte boundary
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    assert _fused_equals_chain(odd, rand[:256])


@pytest.mark.cuda
def test_past_32_bit_indices_on_card(cuda):
    """A tensor of more than 2^31 elements goes in pieces of whole bias
    periods: the chain's bits on every row."""
    g = torch.Generator(device=cuda).manual_seed(7)
    rows, width = 2**31 // 2048 + 3, 2048
    x = torch.empty((rows, width), device=cuda, dtype=BF16)
    for r in range(0, rows, 2**17):
        x[r:r + 2**17] = torch.randn((min(2**17, rows - r), width),
                                     generator=g, device=cuda).to(BF16)
    b = torch.randn(width, generator=g, device=cuda).to(BF16)
    before = BG.bias_gelu.launches
    got = BG.bias_gelu(x, b)
    assert BG.bias_gelu.launches == before + 2
    for r in range(0, rows, 2**17):
        assert _same_bits(got[r:r + 2**17],
                          BG.bias_gelu_plain(x[r:r + 2**17], b)), r


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "non_contiguous", "requires_grad"])
def test_dispatch_on_card(cuda, case, counts):
    """On the card, ``gelu_bias`` keeps F.gelu in f32 (nothing counted),
    and the chain on a non-contiguous input and on one that carries a
    gradient (counted as such, the gradient flows)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((4, 64, 96), generator=g, device=cuda)
    if case != "f32":
        x = x.to(BF16)
    if case == "non_contiguous":
        x = x[:, :, :-1]
    if case == "requires_grad":
        x.requires_grad_(True)
    got = C.gelu_bias(x)
    assert _same_bits(got, _old_gelu(x))
    if case == "requires_grad":
        got.float().sum().backward()
        assert x.grad is not None
    assert counts() == (0, {"f32": 0}.get(case, 1))


@pytest.mark.cuda
def test_wrapper_refuses_on_card(cuda):
    x = torch.zeros((2, 4, 16), dtype=BF16, device=cuda)
    with pytest.raises(TypeError):
        BG.bias_gelu(x, torch.zeros(16, device=cuda))
    with pytest.raises(ValueError):
        BG.bias_gelu(x, torch.zeros(16, dtype=BF16))  # on the CPU
    with pytest.raises(ValueError):
        BG.bias_gelu(x, torch.zeros(4, dtype=BF16, device=cuda))
    with pytest.raises(ValueError):
        BG.bias_gelu(x[:, :, ::2])


@pytest.mark.cuda
def test_whisper_base_bf16_features_on_card(cuda, counts, monkeypatch):
    """A seeded whisper-base (random conv biases too) in bf16 at B = 2,
    padded to 30 s: 8 fused calls (6 FFNs, 2 convs) and no chain; the
    features are the chain's, bit for bit."""
    from radad_tpu_torch.models import whisper as W

    model = W.init_params(W.WhisperEncoder(W.WhisperConfig()),
                          torch.Generator().manual_seed(9))
    with torch.no_grad():
        for conv in (model.conv1, model.conv2):
            conv["bias"].copy_(torch.randn(512) / 10)
    model = model.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(10)
    wav = torch.randn((2, 32000), generator=g, device=cuda) / 10
    with torch.no_grad():
        fused = W.extract_features(model, wav, dtype=BF16)
        assert counts() == (8, 0)
        monkeypatch.setattr(C, "use_bias_gelu", lambda *a, **k: False)
        BG.reset_counts()
        chain = W.extract_features(model, wav, dtype=BF16)
        assert counts() == (0, 8)
    assert _same_bits(fused, chain)


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["group", "layer"])
def test_wav2vec2_base_bf16_features_on_card(cuda, norm, counts,
                                             monkeypatch):
    """A seeded wav2vec2 at base's widths in bf16 at B = 2 (1 s), with
    conv biases, group-normed first conv or every conv layer-normed: 20
    fused calls a forward (7 convs, the positional conv, 12 FFNs) and no
    chain; the features are the chain's, bit for bit. Layer-normed, the 7
    conv layers take ``channel_ln_gelu`` in both forwards (7 launches
    each) and 13 GELUs are left to ``bias_gelu``."""
    model = _wav2vec2(norm, 14, cuda)
    g = torch.Generator(device=cuda).manual_seed(15)
    wav = torch.randn((2, 16000), generator=g, device=cuda) / 10
    n = 20 if norm == "group" else 13
    CLG.reset_counts()
    with torch.no_grad():
        fused = W2.extract_features(model, wav, dtype=BF16)
        assert counts() == (n, 0)
        monkeypatch.setattr(C, "use_bias_gelu", lambda *a, **k: False)
        BG.reset_counts()
        chain = W2.extract_features(model, wav, dtype=BF16)
        assert counts() == (0, n)
    assert _same_bits(fused, chain)
    assert (CLG.channel_ln_gelu.launches, CLG.channel_ln_gelu_plain.calls) \
        == ((0, 0) if norm == "group" else (14, 0))
