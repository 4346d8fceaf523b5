"""Share of the traced slice in which the device is idle inside the
program's device path (span ``radad.device``): launch gaps and the
blocking reads of the search's checks and of the results."""

from harness import spans


def read(run):
    return spans.idle_share_under(run, "radad.device")
