"""Share of the batched rows that were padding to the batcher's bucket,
over the traced slice's calls (``radad.batcher.call:<seq>:<n>/<bucket>``)."""

from harness import spans


def read(run):
    return spans.pad_share(run)
