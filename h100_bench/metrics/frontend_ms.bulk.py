"""Device ms per call of the kernels launched inside the program's
``radad.encoder.frontend`` span: the waveform encoders' strided
convolution stack with its norms and GELUs."""

from harness import span_time


def read(run):
    return span_time.device_ms_per_call(run, "radad.encoder.frontend")
