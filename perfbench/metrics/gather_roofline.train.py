"""gather_roofline.train: gather_rows at its bandwidth roofline in a
traced train unit."""

from perfbench.metrics._shared import gather_roofline_pct


def read(r):
    return gather_roofline_pct(r)
