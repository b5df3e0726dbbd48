"""idle.train: the device idle share of a traced train unit."""

from perfbench.metrics._shared import idle_pct


def read(r):
    return idle_pct(r)
