"""One tiny CPU pass of each driver, its comparison, and that a fault in
the timed path or the control comes out not correct."""

import pytest

import tiny
from harness import common


def _checks(run):
    return {name: (value, limit) for name, value, limit in run.checks}


@pytest.mark.parametrize("config,traffic", [
    ("wav2vec2-base-itw-f32", "online-poisson-3s"),
    ("wav2vec2-base-itw-f32", "bulk-b64"),
    ("whisper-base-itw-bf16", "bulk-b64"),
    ("wav2vec2-base-itw-f32", "train-b128"),
])
def test_tiny_cpu_pass(config, traffic):
    run = tiny.cpu_run(config, traffic)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert run.e2e["setup_s"] > 0
    assert set(_checks(run)) == set(run.config["limits"][
        "train" if traffic.startswith("train") else "serving"])


def test_tiny_traced_pass_reads_its_ranges():
    # the traced slice is the window's second half: some call starts in it
    # as long as a tiny call takes under 2 s, as on a loaded CPU
    run = tiny.cpu_run("wav2vec2-base-itw-f32", "bulk-b64", trace=True,
                       seconds=4.0, traffic_update={"trace_seconds": 2.0})
    s = run.trace_summary
    assert s is not None and s.window_s > 0
    names = {r[0].split(":")[0] for r in s.ranges}
    assert {"predict_batch", "embed", "search", "model"} <= names


def _altered_answer(pipe_model):
    fwd = pipe_model.forward

    def altered(*a, **kw):
        out = fwd(*a, **kw)
        return out + (torch.arange(out.shape[0]) == 0)
    return altered


import torch  # noqa: E402


@pytest.mark.parametrize("config,traffic,number", [
    ("wav2vec2-base-itw-f32", "online-poisson-3s", "logit_err"),
    ("wav2vec2-base-itw-f32", "bulk-b64", "logit_err"),
    ("whisper-base-itw-bf16", "bulk-b64", "logit_rounding"),
])
def test_serving_answer_altered_where_produced_is_not_correct(
        config, traffic, number, monkeypatch):
    from harness import program

    build = program.build_pipeline

    def broken(*a, **kw):
        pipe = build(*a, **kw)
        pipe.model.forward = _altered_answer(pipe.model)
        return pipe
    monkeypatch.setattr(program, "build_pipeline", broken)
    run = tiny.cpu_run(config, traffic)
    assert not run.correct
    value, limit = _checks(run)[number]
    assert value > limit


def _plant(fault, pipe, monkeypatch):
    """A fault of a training step, planted in the program's timed path."""
    import radad_tpu_torch.train.pipeline as tp
    from radad_tpu_torch.train.optim import group_grad_norms

    if fault == "unchanged":  # the step leaves the state as it was
        pipe.opt.step = lambda params, grads: group_grad_norms(grads)
    elif fault == "half_batch":  # the mean over half the batch
        bce = tp.pos_weighted_bce

        def half(logits, labels, pos_weight, valid=None, count=None):
            valid = valid.clone()
            valid[valid.shape[0] // 2:] = False
            return bce(logits, labels, pos_weight, valid, count)
        monkeypatch.setattr(tp, "pos_weighted_bce", half)
    else:  # one row's logit altered where it is produced
        pipe.model.forward = _altered_answer(pipe.model)


@pytest.mark.parametrize("fault,number", [
    ("unchanged", "change_gap"), ("half_batch", "loss_gap"),
    ("altered", "loss_gap")])
def test_train_faults_are_not_correct(fault, number, monkeypatch):
    from harness import program

    build = program.build_pipeline

    def broken(*a, **kw):
        pipe = build(*a, **kw)
        _plant(fault, pipe, monkeypatch)
        return pipe
    monkeypatch.setattr(program, "build_pipeline", broken)
    run = tiny.cpu_run("wav2vec2-base-itw-f32", "train-b128")
    assert not run.correct
    value, limit = _checks(run)[number]
    assert value > limit


@pytest.mark.parametrize("config,traffic", [
    ("wav2vec2-base-itw-f32", "online-poisson-3s"),
    ("whisper-base-itw-bf16", "bulk-b64"),
    ("wav2vec2-base-itw-f32", "train-b128"),
])
def test_control_is_not_correct(config, traffic):
    import time

    import calibrate

    cfg, tr = tiny.tiny_config(config), tiny.tiny_traffic(traffic)
    run = common.Run(cell={"name": "x"}, config=cfg, traffic=tr, seed=21,
                     seconds=0, trace=False, device="cpu",
                     t_start=time.perf_counter())
    if tr["driver"] == "train":
        rows = calibrate.train_readings(run)
        limits = cfg["limits"]["train"]
    else:
        rows = calibrate.serving_readings(run, False)
        limits = cfg["limits"]["serving"]
    by = {r["kind"]: r for r in rows}
    assert any(by["control"][k] > lim for k, lim in limits.items())
    if "float32" in by:
        assert all(by["float32"][k] <= lim for k, lim in limits.items())
    else:
        assert all(by["reference"][k] <= lim for k, lim in limits.items())


@pytest.mark.cuda
def test_a_cell_on_the_card_prints_its_result():
    import json
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, os.path.join(tiny.BENCH_DIR, "run.py"),
         "--workload", "w2v2-bulk", "--seed", "5", "--seconds", "2"],
        capture_output=True, text=True, cwd=os.path.dirname(tiny.BENCH_DIR))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
