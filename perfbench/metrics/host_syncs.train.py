"""host_syncs.train: the host's waits for the card (``host_syncs``)
inside the ``train.step`` spans, over their count."""

from perfbench.metrics._spans import per_span


def read(r):
    return per_span("train.step", "host_syncs")
