"""What the program's own spans say of the traced slice.

``radad_tpu_torch`` opens spans named ``radad.*`` at its serving path's
layer boundaries (``utils/profiling.py::annotate``): ``record_function``
ranges on the profiler's own clock, so they line up with the device's idle
gaps without any alignment. A trace that holds none of them comes from a
program without them, and its readers return None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from harness.common import Run

PROGRAM = "radad."
CALL = "radad.batcher.call:"  # radad.batcher.call:<seq>:<n>/<bucket>


def _program_summary(run: Run):
    s = run.trace_summary
    if s is None or s.window_s <= 0:
        return None
    if not any(r[0].startswith(PROGRAM) for r in s.ranges):
        return None
    return s


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def idle_share_under(run: Run, prefix: str) -> Optional[float]:
    """Share (%) of the traced slice in which the device is idle while a
    span named ``prefix...`` is open: the union of those spans intersected
    with the slice's idle gaps, over the slice. 0 where the program opened
    no such span in the slice."""
    s = _program_summary(run)
    if s is None:
        return None
    spans = _union((ts, ts + dur) for _, ts, dur in s.ranges_named(prefix))
    gaps = sorted((ts, ts + dur) for ts, dur in s.gaps)
    idle, i = 0.0, 0
    for lo, hi in gaps:
        while i < len(spans) and spans[i][1] <= lo:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < hi:
            idle += min(hi, spans[j][1]) - max(lo, spans[j][0])
            j += 1
    return 100.0 * idle * 1e-6 / s.window_s


def pad_share(run: Run) -> Optional[float]:
    """Share (%) of the batched rows that were padding: 1 - sum n / sum
    bucket over the slice's calls that reached their answers (a call span
    holding a ``radad.payload`` span; the one open when the profiler
    stopped is cut there)."""
    s = _program_summary(run)
    if s is None:
        return None
    ends = [ts + dur for name, ts, dur in s.ranges_named("radad.payload")]
    rows = bucket = 0
    for name, ts, dur in s.ranges_named(CALL):
        if not any(ts <= e <= ts + dur for e in ends):
            continue
        n, b = name[len(CALL):].split(":")[1].split("/")
        rows, bucket = rows + int(n), bucket + int(b)
    return 100.0 * (1.0 - rows / bucket) if bucket else None
