"""The device trace of a steady slice of the window: ``torch.profiler``
over CPU and CUDA, exported as a Chrome trace and reduced to kernels,
ranges and busy time.

A kernel belongs to a ``record_function`` range when the host call that
launched it (the runtime or driver event with the kernel's correlation id)
lies inside the range. Busy time is the union of the intervals in which a
kernel, a copy or a memset ran.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver", "runtime")


@dataclass
class Summary:
    window_s: float
    kernels: List[Tuple[str, float, float, Optional[float]]]  # name, ts, dur (us), launch ts
    ranges: List[Tuple[str, float, float]]  # name, ts, dur (us)
    busy_s: float = 0.0
    gaps: List[Tuple[float, float]] = field(default_factory=list)  # (ts, dur) us
    idle_label: str = "no range"  # a gap outside every range

    def device_s_in(self, prefix: str) -> List[float]:
        """Per range whose name starts with ``prefix``: the device seconds
        of the kernels launched inside it."""
        launched = sorted((k[3], k[2]) for k in self.kernels
                          if k[3] is not None)
        starts = [t for t, _ in launched]
        out = []
        for name, ts, dur in self.ranges:
            if not name.startswith(prefix):
                continue
            lo = bisect.bisect_left(starts, ts)
            hi = bisect.bisect_right(starts, ts + dur)
            out.append(sum(d for _, d in launched[lo:hi]) * 1e-6)
        return out

    def ranges_named(self, prefix: str) -> List[Tuple[str, float, float]]:
        return [r for r in self.ranges if r[0].startswith(prefix)]

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for name, _, dur, _ in self.kernels:
            tot[name] = tot.get(name, 0.0) + dur * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps, each named by the innermost range
        open at its middle, or ``idle_label``."""
        out = []
        for ts, dur in sorted(self.gaps, key=lambda g: -g[1])[:n]:
            mid = ts + dur / 2
            open_ = [r for r in self.ranges if r[1] <= mid <= r[1] + r[2]]
            name = (min(open_, key=lambda r: r[2])[0] if open_
                    else self.idle_label)
            out.append([name, dur * 1e-6])
        return out


def reduce(events: List[dict], window_s: float) -> Summary:
    launches: Dict[int, float] = {}
    kernels, ranges, device = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in _DEVICE_CATS:
            device.append((float(e["ts"]), float(e["dur"])))
            kernels.append((e["name"], float(e["ts"]), float(e["dur"]),
                            args.get("correlation")))
        elif cat == "user_annotation":
            ranges.append((e["name"], float(e["ts"]), float(e["dur"])))
        elif cat in _LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = float(e["ts"])
    kernels = [(n, ts, d, launches.get(c)) for n, ts, d, c in kernels]
    busy, gaps = 0.0, []
    end = None
    for ts, dur in sorted(device):
        if end is None or ts > end:
            if end is not None:
                gaps.append((end, ts - end))
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    return Summary(window_s=window_s, kernels=kernels, ranges=ranges,
                   busy_s=busy * 1e-6, gaps=gaps)


class Tracer:
    """Starts and stops the profiler on the thread that runs the program's
    calls, and reduces the trace once stopped."""

    def __init__(self, scratch: str, idle_label: str = "no range"):
        self.idle_label = idle_label
        self.path = os.path.join(scratch, "trace.json")
        self.prof = None
        self.t0 = 0.0
        self.summary: Optional[Summary] = None

    @property
    def running(self) -> bool:
        return self.prof is not None and self.summary is None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self, device) -> None:
        """Start and stop the profiler once around a trivial op, in
        set-up: the first start initializes the device's tracing, which
        takes seconds."""
        prof = self._profile()
        prof.start()
        (torch.ones(8, device=device) * 2).sum().item()
        prof.stop()

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(self.path)
        self.summary = reduce(events, window)
        self.summary.idle_label = self.idle_label

    def describe(self) -> str:
        s = self.summary
        loose = sum(k[3] is None for k in s.kernels)
        return (f"trace: {s.window_s:.3f} s, busy {s.busy_s:.3f} s, "
                f"{len(s.kernels)} device ops ({loose} without a launch "
                f"event), {len(s.ranges)} ranges")
