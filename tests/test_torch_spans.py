"""The serving path's spans (``utils.profiling.annotate``) on the CPU: the
names, nesting and order a profiler started on the batcher's thread records
for a batched call, the call number each answer carries, and that with no
profiler on the thread no ``record_function`` is entered and the answers
are unchanged."""

import itertools
import json
import os
import queue
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_encoder import TINY

# prefixes the benchmark's readers match against range names
READER_PREFIXES = ("embed:", "search", "predict_batch:", "device_path",
                   "model")
# the host's stages on one thread: never two at once
HOST_STAGES = ("radad.batcher.wait", "radad.batcher.linger", "radad.decode",
               "radad.device", "radad.payload")


@pytest.fixture(scope="module")
def pipe(tmp_path_factory, synthetic_dataset):
    from radad_tpu_torch.config import Config
    from radad_tpu_torch.data.manifest import load_manifests
    from radad_tpu_torch.models.encoder import FrozenEncoder
    from radad_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                                 Wav2Vec2Model, init_params)
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    arch = Wav2Vec2Config(**TINY)
    model = init_params(Wav2Vec2Model(arch),
                        torch.Generator().manual_seed(0)).eval()
    enc = FrozenEncoder(name="wav2vec2", model_name="tiny", arch_cfg=arch,
                        model=model, pretrained=False,
                        layers_to_use=(-2, -1))
    root = str(tmp_path_factory.mktemp("spans_run"))
    cfg = Config().replace(data_root=root,
                           vector_db_path=os.path.join(root, "vdb"),
                           db_batch_size=8, use_layer_norm=True,
                           use_batch_norm=False)
    p = DetectionPipeline(cfg, encoder=enc, device="cpu")
    p.build_vector_database(load_manifests(synthetic_dataset)["train"],
                            save=False)
    return p


@pytest.fixture(scope="module")
def paths(synthetic_dataset):
    from radad_tpu_torch.data.manifest import load_manifests

    return list(load_manifests(synthetic_dataset)["val"].paths)


def _spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def batched(pipe, paths, tmp_path_factory):
    """Five requests through a ``PredictBatcher(max_batch=4)`` whose
    profiler is started from inside its first call and stopped from inside
    its third, on the batcher's thread: the first call holds until three
    more requests are queued, so they go out as one call of 3 padded to 4
    after the linger. → (spans, the three answers of call 2)."""
    from radad_tpu_torch.serve.app import PredictBatcher

    trace = str(tmp_path_factory.mktemp("spans_trace") / "trace.json")
    queued = threading.Event()
    prof = {}
    inner = pipe.predict_batch

    def predict_batch(batch):
        if "on" not in prof:
            prof["on"] = profile(activities=[ProfilerActivity.CPU])
            prof["on"].start()
            assert queued.wait(60)
        elif "done" not in prof and len(batch) == 1:
            prof["on"].stop()
            prof["on"].export_chrome_trace(trace)
            prof["done"] = True
        return inner(batch)

    pipe.predict_batch = predict_batch
    batcher = PredictBatcher(pipe, max_batch=4, linger_ms=100.0)
    try:
        first = threading.Thread(target=batcher.predict, args=(paths[0],))
        first.start()
        out = [None] * 3

        def send(i):
            out[i] = batcher.predict(paths[1 + i])
        three = [threading.Thread(target=send, args=(i,)) for i in range(3)]
        for t in three:
            t.start()
        deadline = time.monotonic() + 60
        while batcher._q.qsize() < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        queued.set()
        for t in [first] + three:
            t.join(60)
        time.sleep(0.05)  # the worker back in its wait on an empty queue
        batcher.predict(paths[4])
    finally:
        batcher.close()
        del pipe.predict_batch
    assert all(o is not None for o in out)
    return _spans(trace), out


def test_batched_call_leaves_its_spans_nested(batched):
    spans, out = batched
    names = [s[0] for s in spans]
    calls = [s for s in spans if s[0].startswith("radad.batcher.call:")]
    # the first call started before the profiler; the third, open when it
    # stopped, ends there
    assert [c[0] for c in calls] == ["radad.batcher.call:2:3/4",
                                     "radad.batcher.call:3:1/1"]
    call = calls[0]
    assert "radad.batcher.wait" in names
    (linger,) = [s for s in spans if s[0] == "radad.batcher.linger"]
    assert linger[2] <= call[1] and linger[2] - linger[1] >= 50e3  # us
    by = {n: [s for s in spans if s[0] == n and _inside(s, call)]
          for n in ("radad.decode", "radad.device", "radad.payload")}
    assert all(len(v) == 1 for v in by.values()), by
    dec, dev, pay = by["radad.decode"][0], by["radad.device"][0], \
        by["radad.payload"][0]
    assert dec[2] <= dev[1] and dev[2] <= pay[1]
    for name in ("radad.embed", "radad.search", "radad.model"):
        assert len([s for s in spans if s[0] == name and _inside(s, dev)]) \
            == 1, name
    # the call number each answer carries is the span's
    assert [o["stage_ms"]["call"] for o in out] == [2, 2, 2]
    assert all(o["stage_ms"]["batch"] == 4 for o in out)


def test_host_stages_never_overlap(batched):
    spans, _ = batched
    host = sorted(s for s in spans if s[0] in HOST_STAGES)
    assert {s[0] for s in host} == set(HOST_STAGES)
    ordered = sorted(host, key=lambda s: s[1])
    for a, b in zip(ordered, ordered[1:]):
        assert a[2] <= b[1], (a, b)


def test_no_span_matches_a_readers_prefix(batched):
    spans, _ = batched
    ours = {s[0] for s in spans}
    assert ours and all(n.startswith("radad.") for n in ours)
    assert not any(n.startswith(p) for n in ours for p in READER_PREFIXES)


def test_no_profiler_enters_no_record_function(pipe, paths, monkeypatch):
    from radad_tpu_torch.serve.app import PredictBatcher
    from radad_tpu_torch.utils import profiling

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    pipe.predict_batch(paths)
    pipe.predict(paths[0])
    # a profiler on this thread records nothing of the batcher's thread
    batcher = PredictBatcher(pipe, max_batch=4, linger_ms=1.0)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            assert batcher.predict(paths[0])["stage_ms"]["call"] == 1
            assert batcher.predict(paths[1])["stage_ms"]["call"] == 2
    finally:
        batcher.close()
    with pytest.raises(AssertionError, match="with no profiler"):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.annotate("radad.x"):
                pass


def _answer(o):
    return {k: v for k, v in o.items() if k != "stage_ms"}


def test_answers_equal_with_and_without_the_profiler(pipe, paths,
                                                     tmp_path):
    paths = paths[:3]
    plain = pipe.predict_batch(paths)
    single = pipe.predict(paths[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = pipe.predict_batch(paths)
        traced_single = pipe.predict(paths[0])
    assert [_answer(o) for o in traced] == [_answer(o) for o in plain]
    assert traced_single == single
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    names = [s[0] for s in _spans(path)]
    # predict_batch's three stages, and predict's inner spans too
    assert names.count("radad.decode") == 1
    assert names.count("radad.device") == 1
    assert names.count("radad.payload") == 1
    for name in ("radad.embed", "radad.search", "radad.model"):
        assert names.count(name) == 2, name


def test_linger_deadline_reads_the_monotonic_clock(pipe, paths,
                                                   monkeypatch):
    """A step of the wall clock neither cuts nor stretches the linger."""
    from radad_tpu_torch.serve.app import PredictBatcher

    hours = itertools.count(0.0, 3600.0)  # an hour forward at every read
    monkeypatch.setattr(time, "time", lambda: next(hours))
    gate = threading.Event()
    inner = pipe.predict_batch
    sizes = []

    def predict_batch(batch):
        sizes.append(len(batch))
        if len(sizes) == 1:
            assert gate.wait(60)
        return inner(batch)

    pipe.predict_batch = predict_batch
    batcher = PredictBatcher(pipe, max_batch=4, linger_ms=1000.0)
    results = queue.Queue()
    try:
        threads = [threading.Thread(
            target=lambda p=p: results.put(batcher.predict(p)))
            for p in paths[:3]]
        threads[0].start()
        while not sizes:
            time.sleep(0.005)
        threads[1].start()
        threads[2].start()
        while batcher._q.qsize() < 2:
            time.sleep(0.005)
        gate.set()  # two queued: they linger for a third
        time.sleep(0.1)
        late = threading.Thread(
            target=lambda: results.put(batcher.predict(paths[3])))
        late.start()
        for t in threads + [late]:
            t.join(60)
    finally:
        batcher.close()
        del pipe.predict_batch
    # the straggler, sent 0.1 s into a 1 s linger, joined the second call
    assert sizes == [1, 4]
    assert results.qsize() == 4
