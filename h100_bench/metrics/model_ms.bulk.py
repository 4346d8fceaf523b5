"""Device ms per call of the kernels launched inside the program's fusion
model span (``radad.model``) in the traced slice."""

from harness import readers


def read(run):
    return readers.device_ms_per_range(run, "radad.model")
