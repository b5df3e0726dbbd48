"""h2d_gbps.eval: the bytes ``batch_to_torch`` copies (``h2d_bytes``)
over the time of its ``data.h2d`` spans, in GB/s."""

from perfbench.metrics._spans import spans, window


def read(r):
    got = spans("data.h2d")
    secs = sum(s.seconds for s in got)
    if not got or secs <= 0:
        return None
    return sum(window().under("data.h2d", "h2d_bytes")) / secs / 1e9
