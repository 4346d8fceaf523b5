"""Device ms per call of the kernels launched inside the embed range
(segments, encoder, TPP) of the traced slice."""

from harness import readers


def read(run):
    return readers.device_ms_per_range(run, "embed:")
