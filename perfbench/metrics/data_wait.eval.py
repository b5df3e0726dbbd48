"""data_wait.eval: the main thread's ``data.wait`` time (the eval loop
blocked on the val loader) over the traced unit's window, in %."""

from perfbench.metrics._spans import spans


def read(r):
    got = spans("data.wait", main_thread=True)
    if not got or r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * sum(s.seconds for s in got) / r.trace.window_s
