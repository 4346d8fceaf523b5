"""WavLM-Large's configuration through the harness: its encoder file's
weights load strictly into the port's model, the cell runs at the CPU
cut, the operation counts match counts by hand, and the cell's own metrics
read what a trace holds and nothing where it holds nothing."""

import pytest
import torch

import tiny
from flops import attention_bias, counts, peaks
from harness import common, trace
from harness import weights as W

CONFIG = "wavlm-large-itw-bf16"
METRICS = ("rel_bias_ms.bulk", "frontend_ms.bulk", "mha_bias_roofline.bulk")


def _arch_cfg(cfg):
    from radad_tpu_torch.models.wavlm import WavLMConfig

    return WavLMConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg["architecture"].items()})


@pytest.mark.parametrize("full", [False, True])
def test_weight_spec_is_the_port_models_state_dict(full):
    from radad_tpu_torch.models.wavlm import WavLMModel

    cfg = common.load_config(CONFIG) if full else tiny.tiny_config(CONFIG)
    spec = common.encoder(cfg).weights(cfg["architecture"])
    if full:  # names and shapes only: the published widths on no memory
        with torch.device("meta"):
            want = WavLMModel(_arch_cfg(cfg)).state_dict()
        assert {n: tuple(s) for n, s, _ in spec} == {
            n: tuple(t.shape) for n, t in want.items()}
        # ~315 M parameters (HF's count without the masked-frame embedding)
        assert 315e6 < sum(t.numel() for t in want.values()) < 316e6
        return
    model = WavLMModel(_arch_cfg(cfg))
    model.load_state_dict(W.make(spec, 7, "cpu"), strict=True)


def test_the_configuration_runs_through_the_harness_at_the_cpu_cut():
    run = tiny.cpu_run(CONFIG, "bulk-b64")
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert {n for n, _, _ in run.checks} == set(
        run.config["limits"]["serving"])


def test_segment_flops_by_hand():
    # 32,000 samples: conv lengths 6,399, 3,199, 1,599, 799, 399, 199, 99
    lengths = [6399, 3199, 1599, 799, 399, 199, 99]
    kernels = [10, 3, 3, 3, 3, 2, 2]
    conv = 2 * 6399 * 512 * 1 * 10 + sum(
        2 * n * 512 * 512 * k for n, k in zip(lengths[1:], kernels[1:]))
    proj = 2 * 99 * 512 * 1024
    pos = 2 * 99 * 1024 * 64 * 128
    layer = (2 * 99 * (4 * 1024 * 1024 + 2 * 1024 * 4096)
             + 4 * 99 * 99 * 1024 + 2 * 99 * 16 * 64 * 8)
    cfg = common.load_config(CONFIG)
    enc = common.encoder(cfg)
    assert enc.segment_flops(cfg["architecture"], cfg["pipeline"]) == (
        conv + proj + pos + 24 * layer)
    # ~72 GFLOP a window: front end 9.8, positional conv 1.7, 24 x 2.53
    assert 71e9 < conv + proj + pos + 24 * layer < 73e9
    assert counts.attention_shape(cfg, 64) == (128, 99, 16, 64)
    assert enc.width(cfg["architecture"]) == 1024


def test_bias_attention_count_by_hand():
    b, t, h, hd = 128, 99, 16, 64
    ops = 4 * b * h * t * t * hd + 2 * b * h * t * t
    nbytes = 2 * (4 * b * t * h * hd + b * t * h + h * t * t)
    assert attention_bias.ops(b, t, h, hd) == ops
    assert attention_bias.nbytes(b, t, h, hd, 2) == nbytes
    # at T = 99 the bytes bound it: 0.0312 ms against 0.0052 of operations
    least = attention_bias.least_s(b, t, h, hd, 2, peaks.FLOPS["bfloat16"],
                                   peaks.HBM_BYTES_PER_S)
    assert least == nbytes / 3.35e12 > ops / 989e12


def _events(bias_kernel: bool, spans: bool):
    """One call of 64 clips: its embed range, the program's spans inside
    it, and a kernel launched in each."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "embed:64",
           "ts": 0.0, "dur": 1000.0}]
    if spans:
        ev += [{"ph": "X", "cat": "user_annotation", "name": name,
                "ts": ts, "dur": 10.0}
               for name, ts in (("radad.encoder.frontend", 10.0),
                                ("radad.wavlm.pos_bias", 30.0),
                                ("radad.wavlm.gate", 50.0),
                                ("radad.wavlm.gate", 70.0))]
    names = ["conv", "gather", "gate_linear", "gate_linear",
             "void (anonymous namespace)::mha_bf16_resident_kernel"
             f"<64, {'true' if bias_kernel else 'false'}, 7>(int)"]
    for i, (name, launch) in enumerate(zip(names, (12, 32, 52, 72, 90))):
        ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": float(launch), "dur": 1.0, "args": {"correlation": i}},
               {"ph": "X", "cat": "kernel", "name": name,
                "ts": 100.0 + 100 * i, "dur": 40.0 + 10 * i,
                "args": {"correlation": i}}]
    return ev


def _read(name, summary):
    import run as runner

    r = common.Run(cell={"name": "x"}, config=common.load_config(CONFIG),
                   traffic={}, seed=0, seconds=1, trace=True, device="cpu",
                   t_start=0.0)
    r.trace_summary = summary
    return runner.load_module("metrics", name).read(r)


def test_the_cells_metrics_read_their_spans_and_kernels():
    s = trace.reduce(_events(bias_kernel=True, spans=True), window_s=1e-3)
    assert _read("frontend_ms.bulk", s) == pytest.approx(40e-3)
    # pos_bias 50 us, two gates 60 + 70 us
    assert _read("rel_bias_ms.bulk", s) == pytest.approx(180e-3)
    # 24 layers of the bias body at (128, 99, 16, 64) over its 80 us
    least = 24 * attention_bias.least_s(128, 99, 16, 64, 2, 989e12, 3.35e12)
    assert _read("mha_bias_roofline.bulk", s) == pytest.approx(
        100 * least / 80e-6)


@pytest.mark.parametrize("name", METRICS)
def test_the_cells_metrics_read_nothing_where_nothing_ran(name):
    # a run with no trace, and a program without the spans or the bias body
    assert _read(name, None) is None
    bare = trace.reduce(_events(bias_kernel=False, spans=False), 1e-3)
    assert _read(name, bare) is None
