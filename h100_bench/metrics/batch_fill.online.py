"""Requests answered over predict_batch calls in the window."""

from harness import readers


def read(run):
    return readers.ratio(run, "answered", "calls")
