"""Device ms per call of the kernels launched inside the program's
``radad.wavlm.pos_bias`` span and its ``radad.wavlm.gate`` spans (one a
layer): WavLM's relative position bias and its gates."""

from harness import span_time


def read(run):
    return span_time.device_ms_per_call(run, "radad.wavlm.")
