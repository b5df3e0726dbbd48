"""collate_ms.eval: the median ``data.collate`` span (one val batch
augmented and collated on a loader thread) of the traced pass, in ms."""

from perfbench.metrics._spans import median_ms


def read(r):
    return median_ms("data.collate")
