"""Host ms per step of StepFns.fetch, ended by a synchronize, in the
traced slice."""

from harness import readers


def read(run):
    return readers.mean(run, "retrieve_ms")
