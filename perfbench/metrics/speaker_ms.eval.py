"""speaker_ms.eval: the median ``eval.speaker`` span (a val batch's graph
and greedy decode to its captions read back), in ms."""

from perfbench.metrics._spans import median_ms


def read(r):
    return median_ms("eval.speaker")
