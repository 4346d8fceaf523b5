"""Mean wait of a request from enqueue to the start of its predict_batch
(the batcher's own stage_ms["queue"]), over the window's answers."""

from harness import readers


def read(run):
    return readers.mean(run, "queue_ms")
