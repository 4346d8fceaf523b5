"""Device ms per call of the kernels launched inside the search range
(certified search and neighbor gather) of the traced slice."""

from harness import readers


def read(run):
    return readers.device_ms_per_range(run, "search")
