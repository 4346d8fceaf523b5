"""Model operations of the window's train steps before the traced slice
(the fusion model's forward and backward, 3x its forward, at B rows) over
their time, against the configuration's precision peak."""

from harness import readers


def read(run):
    return readers.mfu(run, run.counters.get("plain_s"))
