"""Percentiles over every request, timed from its due time, and the
open-loop schedule drawn from the seed."""

import threading
import time
import types

import numpy as np
import pytest

import tiny
from harness import common


def test_nearest_rank_over_all_requests():
    values = list(range(1, 101))  # 1 .. 100
    assert common.nearest_rank(values, 0.95) == 95
    assert common.nearest_rank(values, 0.50) == 50
    assert common.nearest_rank([7.0], 0.95) == 7.0
    # a missing request counts at the time it was waited for
    assert common.nearest_rank([1.0] * 94 + [1e9] * 6, 0.95) == 1e9


class _SlowBatcher:
    """Answers one request at a time, each in 30 ms: a queue forms."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sent = []

    def predict(self, path):
        with self.lock:
            self.sent.append((time.perf_counter(), path))
            time.sleep(0.03)
            return {"stage_ms": {"queue": 0.0}}


def _online(seed, batcher):
    online = tiny.load_driver("online")
    tr = tiny.tiny_traffic("online-poisson-3s")
    run = common.Run(cell={"name": "x"}, config={}, traffic=tr, seed=seed,
                     seconds=1.0, trace=False, device="cpu", t_start=0.0)
    sv = types.SimpleNamespace(db_paths=[f"db_{i}" for i in range(8)],
                               pool=[f"pool_{i}" for i in range(16)])
    on = online.Online(sv=sv, inst=types.SimpleNamespace(
        calls=[], reset=lambda: None), batcher=batcher, tracer=None,
        clock={})
    return online.window(run, on, 40.0, 1.0)


def test_latency_is_timed_from_the_due_time():
    b = _SlowBatcher()
    w = _online(3, b)
    assert w["n"] == 40 and all(r is not None for r in w["results"])
    # one server at 30 ms a request against 40 a second: the queue grows,
    # and the last requests wait for the ones before them
    assert max(w["lat"]) > 200.0
    assert min(w["lat"]) >= 30.0 - 1.0
    # the generator kept to its schedule (it never waits for answers)
    assert common.nearest_rank(w["late"], 0.5) < 20.0


def test_schedule_is_fixed_by_the_seed():
    wa = _online(11, _SlowBatcher())
    a = wa["paths"]
    b = _online(11, _SlowBatcher())["paths"]
    wc = _online(12, _SlowBatcher())
    c = wc["paths"]
    assert a == b and a != c and len(a) == len(c) == 40
    # a tenth are catalog picks of DB clips, on every seed
    assert sum(p.startswith("db_") for p in a) == 4
    assert sum(p.startswith("db_") for p in c) == 4
    # every seed offers the same gaps, in another order, and ends together
    ga, gc = np.diff(wa["due"], prepend=0.0), np.diff(wc["due"], prepend=0.0)
    assert not np.allclose(ga, gc)
    assert np.allclose(np.sort(ga), np.sort(gc))
    assert wa["due"][-1] == pytest.approx(wc["due"][-1]) and wa["due"][-1] < 1.0
