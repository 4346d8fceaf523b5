"""Share of the traced slice in which no kernel, copy or memset ran."""

from harness import readers


def read(run):
    return readers.idle_share(run)
