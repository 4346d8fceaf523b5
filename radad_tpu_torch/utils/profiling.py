"""Profiling and tracing utilities.

Counterpart: ``radad_tpu/utils/profiling.py`` (the reference's timed loops
with ``cuda.synchronize``, projection.py:140-153, detection_model.py:
272-306):

  * ``trace(logdir)`` — ``torch.profiler`` over the host and the card,
    writing a TensorBoard-loadable trace of everything run inside;
  * ``annotate(name)`` — a named span in that trace
    (``torch.profiler.record_function``), and nothing where no profiler
    runs on the calling thread: the serving path's spans (``radad.*``)
    stay in place and cost one check when tracing is off;
  * ``profile_fn`` — the timed-loop profiler: CUDA events and a
    synchronize a call on the card, ``perf_counter`` on the CPU;
  * ``memory_stats`` — the card's allocator counters.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Dict

import numpy as np
import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

from radad_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Profile the block (host activity, and the card's on ``"cuda"``) and
    write its trace into ``logdir`` as ``<worker>.<time>.pt.trace.json``,
    which TensorBoard's profiler plugin and Perfetto load. Yields the
    ``torch.profiler.profile``."""
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
    logger.info("profiler trace written to %s", logdir)


_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def annotate(name: str):
    """Named span inside an active trace: a ``record_function`` (a
    ``user_annotation`` event on the trace's own clock) where the calling
    thread runs a profiler, else one shared null context. The profiler's
    state is per thread, so a span on another thread than the one that
    started it records nothing. The check reads a thread-local flag, far
    cheaper than entering a ``record_function`` with no profiler."""
    if _profiler_enabled():
        return record_function(name)
    return _NO_SPAN


def profile_fn(fn: Callable, *args, iterations: int = 20,
               warmup_iters: int = 2, label: str = "fn",
               device="cuda") -> Dict[str, float]:
    """Timed-loop profile of ``fn(*args)`` → stats dict (the reference's
    profile_performance contract). On ``"cuda"`` each call is timed by two
    CUDA events around it and a synchronize after it (the card's time from
    the call's first launch to its last result, host gaps between its
    launches included); on ``"cpu"`` by ``perf_counter``."""
    on_card = resolve_device(device).type == "cuda"
    for _ in range(warmup_iters):
        fn(*args)
    if on_card:
        torch.cuda.synchronize()
    times = []
    for _ in range(iterations):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    stats = {
        "label": label,
        "mean_ms": float(times.mean() * 1e3),
        "median_ms": float(np.median(times) * 1e3),
        "p90_ms": float(np.percentile(times, 90) * 1e3),
        "iterations": iterations,
    }
    logger.info("profile %s: %.3f ms median (%d iters)",
                label, stats["median_ms"], iterations)
    return stats


def memory_stats(device="cuda") -> Dict[str, int]:
    """The integer counters of ``torch.cuda.memory_stats`` (bytes and
    counts: ``allocated_bytes.all.peak``, ...); ``{}`` on ``"cpu"``, which
    keeps no such counters."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    return {k: int(v) for k, v in torch.cuda.memory_stats(dev).items()
            if isinstance(v, (int, float))}
