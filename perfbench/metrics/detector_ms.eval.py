"""detector_ms.eval: the median ``eval.detector`` span (a val batch's
detector forward to its proposals read back), in ms."""

from perfbench.metrics._spans import median_ms


def read(r):
    return median_ms("eval.detector")
