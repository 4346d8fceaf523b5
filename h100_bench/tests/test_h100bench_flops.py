"""The harness's operation counts, through each encoder file's interface,
against counts made by hand at the published shapes."""

import tiny  # noqa: F401  (puts the harness on the path)
from flops import counts, peaks
from harness import common


def _cfg(name):
    return common.load_config(name)


def test_wav2vec2_base_segment_by_hand():
    # 32,000 samples: conv lengths 6,399, 3,199, 1,599, 799, 399, 199, 99
    lengths = [6399, 3199, 1599, 799, 399, 199, 99]
    kernels = [10, 3, 3, 3, 3, 2, 2]
    conv = 2 * 6399 * 512 * 1 * 10 + sum(
        2 * n * 512 * 512 * k for n, k in zip(lengths[1:], kernels[1:]))
    proj = 2 * 99 * 512 * 768
    pos = 2 * 99 * 768 * 48 * 128
    layer = 2 * 99 * (4 * 768 * 768 + 2 * 768 * 3072) + 4 * 99 * 99 * 768
    want = conv + proj + pos + 12 * layer
    cfg = _cfg("wav2vec2-base-itw-f32")
    got = common.encoder(cfg).segment_flops(cfg["architecture"],
                                            cfg["pipeline"])  # 32,000
    assert got == want
    # a 3 s clip is two 2 s windows at a 1 s hop: ~56 GFLOP
    assert counts.windows_per_clip(_cfg("wav2vec2-base-itw-f32")) == 2
    assert 55e9 < counts.encoder_flops(_cfg("wav2vec2-base-itw-f32")) < 57e9


def test_whisper_base_padded_segment_by_hand():
    # 30 s padded: 3,000 mel frames, 1,500 encoder frames
    mel = 2 * 3000 * 201 * 80
    convs = 2 * 3000 * 512 * 80 * 3 + 2 * 1500 * 512 * 512 * 3
    layer = 2 * 1500 * (4 * 512 * 512 + 2 * 512 * 2048) + 4 * 1500 ** 2 * 512
    want = mel + convs + 6 * layer
    cfg = _cfg("whisper-base-itw-bf16")
    assert common.encoder(cfg).segment_flops(cfg["architecture"],
                                             cfg["pipeline"]) == want
    assert counts.attention_shape(cfg, 64) == (128, 1500, 8, 64)
    assert 170e9 < counts.encoder_flops(cfg) < 180e9


def test_fusion_forward_by_hand():
    d, k = 5376, 5
    per_neighbor = 2 * (d * 256 + 256 * 1 + d * 256 + 256 * d) + 2 * d
    rest = 2 * (d * 256 + 256 * 128) + 2 * (d + 128) * 128
    head = 2 * (128 * 64 + 64 * 32 + 32 * 1)
    want = k * per_neighbor + rest + head
    assert counts.fusion_flops(_cfg("wav2vec2-base-itw-f32")) == want
    # ~5.8 GFLOP at B = 128
    assert 5.7e9 < 128 * want < 6.0e9


def test_attention_least_time_is_the_larger_bound():
    # whisper-base, 128 windows: 4.72e12 operations at 989 TFLOP/s
    s = counts.attention_least_s(128, 1500, 8, 64, 2, peaks.FLOPS["bfloat16"],
                                 peaks.HBM_BYTES_PER_S)
    ops = 4.0 * 128 * 8 * 1500 ** 2 * 64
    assert s == ops / 989e12
    # one short sequence is bound by its bytes
    s = counts.attention_least_s(1, 4, 1, 64, 2, 989e12, 3.35e12)
    assert s == 4.0 * 4 * 64 * 2 / 3.35e12
