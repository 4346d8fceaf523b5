"""Certified searches whose certificate failed, over searches, in the
window (FlatIndex's own counters)."""

from harness import readers


def read(run):
    return readers.ratio(run, "fallbacks", "searches", 100.0)
