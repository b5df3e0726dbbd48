"""idle.eval: the device idle share of a traced eval unit."""

from perfbench.metrics._shared import idle_pct


def read(r):
    return idle_pct(r)
