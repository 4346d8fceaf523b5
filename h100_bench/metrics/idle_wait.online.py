"""Share of the traced slice in which the device is idle while the
batcher waits on an empty queue (span ``radad.batcher.wait``): load, not
a cost of the program."""

from harness import spans


def read(run):
    return spans.idle_share_under(run, "radad.batcher.wait")
