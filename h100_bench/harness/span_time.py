"""Device time under the program's own spans, per call."""

from __future__ import annotations

from typing import Optional

from harness.common import Run


def device_ms_per_call(run: Run, prefix: str) -> Optional[float]:
    """Device milliseconds of the kernels launched inside the program's
    spans named ``prefix...`` in the traced slice, over the slice's embed
    ranges (one a ``predict_batch`` call; the slice holds whole calls).
    None where the program opened no such span: a program without it."""
    s = run.trace_summary
    if s is None:
        return None
    per_span = s.device_s_in(prefix)
    calls = len(s.ranges_named("embed:"))
    if not per_span or not calls:
        return None
    return 1e3 * sum(per_span) / calls
