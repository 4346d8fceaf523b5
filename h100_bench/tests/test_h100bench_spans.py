"""The readers of the program's own spans: on a slice with planted gaps and
spans, each idle part, the padding share and the fusion model's device time
read their planted values; the parts never exceed the idle share; a span
the slice lacks reads 0, and a run without a trace, or whose program opens
no span, reads None."""

import pytest

import tiny  # noqa: F401  (puts the harness on the path)
from harness import common, readers, trace

# a 10 ms slice (us): each host stage's span over one planted idle gap
RANGES = [
    ("radad.batcher.wait", 0.0, 600.0),
    ("radad.batcher.wait", 400.0, 800.0),  # overlaps the first: one union
    ("radad.batcher.linger", 1200.0, 300.0),
    ("radad.batcher.call:7:3/4", 1500.0, 5100.0),
    ("predict_batch:4", 1510.0, 5000.0),
    ("radad.decode", 1500.0, 1000.0),
    ("radad.device", 2500.0, 3500.0),
    ("embed:4", 2600.0, 300.0),
    ("radad.model", 5000.0, 500.0),
    ("radad.payload", 6000.0, 500.0),
    # open when the profiler stopped: it never reached its answers
    ("radad.batcher.call:8:16/16", 9000.0, 1000.0),
]
GAPS = [(0.0, 1000.0),      # wait
        (1250.0, 200.0),    # linger
        (1500.0, 1000.0),   # decode
        (3000.0, 100.0),    # device: a launch gap
        (6000.0, 500.0),    # payload
        (6500.0, 200.0)]    # under no host stage: the remainder
KERNELS = [("gemm", 5200.0, 300.0, 5100.0)]  # launched inside radad.model
PLANTED = {"idle_wait.online": 10.0, "idle_linger.online": 2.0,
           "idle_decode.online": 10.0, "idle_decode.bulk": 10.0,
           "idle_device.online": 1.0, "idle_device.bulk": 1.0,
           "idle_payload.online": 5.0, "idle_payload.bulk": 5.0,
           "pad_share.online": 25.0,
           "model_ms.online": 0.3, "model_ms.bulk": 0.3}
PARTS = ("idle_wait.online", "idle_linger.online", "idle_decode.online",
         "idle_device.online", "idle_payload.online")


def _run(ranges=RANGES, summary=True):
    r = common.Run(cell={"name": "x"}, config=common.load_config(
        "wav2vec2-base-itw-f32"), traffic={}, seed=0, seconds=1,
        trace=True, device="cpu", t_start=0.0)
    if summary:
        busy = 10000.0 - sum(d for _, d in GAPS)
        r.trace_summary = trace.Summary(
            window_s=0.01, kernels=list(KERNELS), ranges=list(ranges),
            busy_s=busy * 1e-6, gaps=list(GAPS))
    return r


def _read(name, run):
    import run as runner

    return runner.load_module("metrics", name).read(run)


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_each_reader_reads_its_planted_value(name):
    assert _read(name, _run()) == pytest.approx(PLANTED[name], abs=1e-9)


def test_the_parts_add_up_to_no_more_than_the_idle_share():
    run = _run()
    parts = sum(_read(n, run) for n in PARTS)
    idle = readers.idle_share(run)
    assert idle == pytest.approx(30.0)
    # the remainder is the planted gap under no host stage
    assert idle - parts == pytest.approx(2.0)


def test_a_span_the_slice_lacks_reads_zero():
    ranges = [r for r in RANGES if r[0] != "radad.batcher.linger"]
    assert _read("idle_linger.online", _run(ranges)) == 0.0
    assert _read("idle_wait.online", _run(ranges)) == pytest.approx(10.0)


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_no_trace_or_no_program_span_reads_none(name):
    assert _read(name, _run(summary=False)) is None
    # a program without the spans: only the harness's own ranges
    harness_only = [r for r in RANGES if not r[0].startswith("radad.")]
    assert _read(name, _run(harness_only)) is None
