"""Share of the traced slice in which the device is idle while the
program assembles the answers on the host (span ``radad.payload``)."""

from harness import spans


def read(run):
    return spans.idle_share_under(run, "radad.payload")
