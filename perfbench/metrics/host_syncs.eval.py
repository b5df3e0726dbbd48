"""host_syncs.eval: the host's waits for the card (``host_syncs``) inside
the ``eval.batch`` spans, over their count."""

from perfbench.metrics._spans import per_span


def read(r):
    return per_span("eval.batch", "host_syncs")
