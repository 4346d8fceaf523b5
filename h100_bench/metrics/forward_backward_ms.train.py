"""Host ms per step of StepFns.forward_backward, ended by a synchronize, in the
traced slice."""

from harness import readers


def read(run):
    return readers.mean(run, "forward_backward_ms")
