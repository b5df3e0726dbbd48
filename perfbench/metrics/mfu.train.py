"""mfu.train: the train step's operations over the window at the peak."""

from perfbench.metrics._shared import mfu_pct


def read(r):
    return mfu_pct(r)
