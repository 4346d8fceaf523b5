"""Share of the traced slice in which the device is idle while the
batcher lingers for stragglers (span ``radad.batcher.linger``)."""

from harness import spans


def read(run):
    return spans.idle_share_under(run, "radad.batcher.linger")
