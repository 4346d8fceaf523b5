"""Model operations of the answered clips (encoder and fusion model)
over the summed predict_batch wall time, against the configuration's
precision peak."""

from harness import readers


def read(run):
    return readers.serving_mfu(run)
