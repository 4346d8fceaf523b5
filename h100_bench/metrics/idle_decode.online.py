"""Share of the traced slice in which the device is idle while the
program decodes the call's clips on the host (span ``radad.decode``)."""

from harness import spans


def read(run):
    return spans.idle_share_under(run, "radad.decode")
