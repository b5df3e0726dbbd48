"""Readings of the program's own spans and counters
(``d3net_tpu_torch.trace``) in the traced unit: the profiler session of
``harness/profile.py`` is the tracer's window. A program without the
tracer, or a window without the spans a metric reads, gives nothing."""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np


def window():
    """The tracer's latest window, or None where the program has none."""
    try:
        from d3net_tpu_torch import trace
    except ImportError:
        return None
    return trace.last_window()


def spans(name: str, main_thread: bool = False) -> List:
    w = window()
    if w is None:
        return []
    out = w.named(name)
    if main_thread:
        tid = threading.main_thread().native_id
        out = [s for s in out if s.tid == tid]
    return out


def median_ms(name: str) -> Optional[float]:
    """The median ``name`` span, in ms."""
    got = spans(name)
    if not got:
        return None
    return 1e3 * float(np.median([s.seconds for s in got]))


def per_span(name: str, counter: str) -> Optional[float]:
    """``counter`` charged inside each ``name`` span, over their count."""
    w = window()
    if w is None or not w.named(name):
        return None
    n = w.under(name, counter)
    return sum(n) / len(n)
