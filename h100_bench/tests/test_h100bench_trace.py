"""The trace's reduction: kernels to ranges by their launch, busy time as
a union, idle gaps named by the range open over them, and the fused
attention's roofline share from it."""

import tiny  # noqa: F401  (puts the harness on the path)
from harness import common, trace


def _events():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "predict_batch:64",
         "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "embed:64",
         "ts": 10.0, "dur": 400.0},
        {"ph": "X", "cat": "user_annotation", "name": "search",
         "ts": 500.0, "dur": 100.0},
        # launches (runtime events) and their kernels
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 20.0, "dur": 2.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name":
         "void (anonymous namespace)::mha_bf16_wgmma_kernel<false>(int)",
         "ts": 100.0, "dur": 300.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 30.0, "dur": 2.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 350.0,
         "dur": 100.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 510.0, "dur": 2.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "exact_dot", "ts": 800.0,
         "dur": 50.0, "args": {"correlation": 3}},
    ]
    return ev


def test_reduce_attributes_kernels_by_launch_and_unions_busy_time():
    s = trace.reduce(_events(), window_s=0.001)
    # embed launched the attention and the gemm, search the exact_dot
    (embed,), (search,) = s.device_s_in("embed:"), s.device_s_in("search")
    assert abs(embed - 400e-6) < 1e-12 and abs(search - 50e-6) < 1e-12
    # 100..450 and 800..850 busy: 400 us
    assert abs(s.busy_s - 400e-6) < 1e-12
    assert s.gaps == [(450.0, 350.0)]
    # the gap lies in predict_batch, outside its embed and search ranges
    assert s.idle_gaps() == [["predict_batch:64", 350e-6]]
    assert s.top_ops(1)[0][0].endswith("mha_bf16_wgmma_kernel<false>(int)")


def test_fused_mha_roofline_reads_the_named_kernels():
    import run as runner

    cfg = common.load_config("whisper-base-itw-bf16")
    r = common.Run(cell={"name": "x"}, config=cfg, traffic={}, seed=0,
                   seconds=1, trace=True, device="cpu", t_start=0.0)
    r.trace_summary = trace.reduce(_events(), window_s=0.001)
    share = runner.load_module("metrics", "fused_mha_roofline.bulk").read(r)
    # 6 layers of 128 x 1,500 x 8 heads of 64 at 989 TFLOP/s: 3.578 ms,
    # against 300 us spent: the test's own numbers, far above 100 %
    want = 100 * 6 * 4.0 * 128 * 8 * 1500 ** 2 * 64 / 989e12 / 300e-6
    assert abs(share - want) < 1e-6 * want
    r.trace_summary = trace.reduce([e for e in _events()
                                    if "mha_" not in e.get("name", "")], 1e-3)
    assert runner.load_module("metrics", "fused_mha_roofline.bulk").read(
        r) is None
