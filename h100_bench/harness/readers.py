"""What the per-layer metric readers (``metrics/<name>.py``) share. Each
reader returns a number, or None where its run holds nothing to read."""

from __future__ import annotations

import statistics
from typing import Optional

from flops import peaks
from harness.common import Run


def mean(run: Run, span: str) -> Optional[float]:
    values = run.spans.get(span)
    return statistics.fmean(values) if values else None


def ratio(run: Run, num: str, den: str, scale: float = 1.0
          ) -> Optional[float]:
    d = run.counters.get(den)
    return None if not d else scale * run.counters.get(num, 0.0) / d


def device_ms_per_range(run: Run, prefix: str) -> Optional[float]:
    """Mean device milliseconds of the kernels launched inside each
    ``record_function`` range named ``prefix...`` in the traced slice."""
    if run.trace_summary is None:
        return None
    per = run.trace_summary.device_s_in(prefix)
    return 1e3 * statistics.fmean(per) if per else None


def idle_share(run: Run) -> Optional[float]:
    s = run.trace_summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def mfu(run: Run, seconds: Optional[float]) -> Optional[float]:
    """Model operations done over ``seconds``, as a share of the peak of
    the configuration's compute precision."""
    flops = run.counters.get("model_flops")
    if not flops or not seconds:
        return None
    peak = peaks.FLOPS[run.config["compute_precision"]]
    return 100.0 * flops / seconds / peak


def serving_mfu(run: Run) -> Optional[float]:
    """Over the summed wall time of the window's ``predict_batch`` calls."""
    return mfu(run, sum(run.spans.get("call_s", [])))
