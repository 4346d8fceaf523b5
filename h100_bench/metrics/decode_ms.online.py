"""Mean host decode per predict_batch call (stage_ms["decode"])."""

from harness import readers


def read(run):
    return readers.mean(run, "decode_ms")
